"""``repro_torch.serve_lm``, the port of ``examples/serve_lm.py``, on the
CPU against the reference.

``serve_lm.requests`` are the example's four requests: prompts of 8, 5,
12 and 3 tokens drawn from ``RandomState(0)`` in that order,
temperatures 0, 0.8, 0.5 and 0, ``max_new`` 24, 12, 24 and 24.  With the
reference's own smoke weights (``PRNGKey(0)``) carried over, the port's
engine (batch 4, cache 256) gives the reference engine's tokens for the
greedy requests (0 and 3) at ``--window 0`` (the full cache) and
``--window 64`` (a ring).  The sampled requests draw from the port's
own generator, not ``jax.random``: they are held to be seeded and in
range.  The CLI prints the example's lines with ``--device cpu`` and,
without it, raises where there is no GPU.  Torch runs on one thread:
the smoke engine is thousands of small ops.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch import serve_lm
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.models import transformer as tr
from test_torch_lm import _both, jref  # noqa: F401
from test_torch_reference import one_thread

ARCH = "olmoe-1b-7b"
LINE = re.compile(r"req (\d+) \(T=([0-9.]+)\): prompt (\d+) tokens -> "
                  r"\[([0-9, ]*)\]")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def test_requests_are_the_examples():
    cfg = reduce_for_smoke(get_arch(ARCH))
    reqs = serve_lm.requests(cfg)
    rng = np.random.RandomState(0)
    assert [(r.rid, len(r.prompt), r.temperature, r.max_new) for r in reqs] \
        == [(0, 8, 0.0, 24), (1, 5, 0.8, 12), (2, 12, 0.5, 24),
            (3, 3, 0.0, 24)]
    for r in reqs:
        assert r.prompt.dtype == np.int32
        assert r.prompt.tolist() == rng.randint(0, cfg.vocab_size,
                                                len(r.prompt)).tolist()


@pytest.mark.parametrize("window", [0, 64])
def test_greedy_requests_give_the_reference_engines_tokens(jref, window):
    jparams, params, jcfg, cfg = _both(jref, ARCH)
    jeng = jref.serving.ServeEngine(jparams, jcfg, batch=serve_lm.BATCH,
                                    cache_len=serve_lm.CACHE_LEN,
                                    window=window)
    reqs = serve_lm.requests(cfg)
    want = jeng.generate([jref.serving.ServeRequest(
        prompt=r.prompt, max_new=r.max_new, temperature=r.temperature,
        rid=r.rid) for r in reqs])
    dec_k.reset_launch_counts()
    reqs, outs, _, eng = serve_lm.serve(params, cfg, window=window,
                                        device="cpu")
    assert dec_k.LAUNCHES["decode_attention"] == 0
    assert eng.state["layers"][0]["k"].shape[1] == (window or 256)
    greedy = [i for i, r in enumerate(reqs) if r.temperature == 0.0]
    assert greedy == [0, 3]
    for i in greedy:
        assert outs[i].tolist() == want[i].tolist(), i
    assert [len(o) for o in outs] == [r.max_new for r in reqs]


def test_sampled_requests_are_seeded_and_in_range():
    cfg = reduce_for_smoke(get_arch(ARCH))
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    runs = [serve_lm.serve(params, cfg, window=64, device="cpu",
                           seed=seed)[1] for seed in (0, 0, 1)]
    for out in runs[0] + runs[2]:
        assert out.dtype == np.int32
        assert ((out >= 0) & (out < cfg.vocab_size)).all()
    assert [o.tolist() for o in runs[0]] == [o.tolist() for o in runs[1]]
    sampled = [1, 2]
    assert [runs[0][i].tolist() for i in sampled] != \
        [runs[2][i].tolist() for i in sampled]


def test_cli_runs_on_the_cpu_and_raises_without_a_gpu(capsys, monkeypatch):
    assert serve_lm.main(["--device", "cpu", "--max-new", "4",
                          "--window", "64"]) == 0
    out = capsys.readouterr().out
    assert "serving olmoe-1b-7b-smoke" in out and "window=64" in out
    assert len(LINE.findall(out)) == 4 and "14 tokens in" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main([])
