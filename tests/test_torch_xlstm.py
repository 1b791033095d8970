"""xLSTM serving in the port (mLSTM + sLSTM) against the JAX reference on
the CPU, at the smoke size (``reduce_for_smoke``: 2 layers [mLSTM,
sLSTM], d 256, 4 mLSTM heads of 128, vocab 1024, f32).  Both packages get
the same numpy inputs and the reference's own initial weights.

Tolerances:
* each mixer (``mlstm_scan``, ``mlstm_scan_sequential``, ``mlstm_decode``,
  ``slstm_scan``, ``slstm_decode``) against its reference counterpart:
  abs/rel 1e-5 (``MIXER_TOL``; f32 sums in other orders);
* whole-model logits: abs/rel 2e-5 (``MODEL_TOL``, as in
  test_torch_lm.py); greedy ``ServeEngine`` tokens equal;
* the port's chunkwise prefill against its own sequential form: 3e-4,
  and prefill against token-by-token decode: 5e-4, the reference's own
  bounds (tests/test_variants_and_perf.py, tests/test_arch_smoke.py).
  The chunkwise form starts its stabilizer at m = 0, the sequential form
  and the decode at m = -1e9, as in the reference; m scales C, n and the
  denominator's floor ``exp(-m)`` alike, so both compute one function
  (``test_mlstm_state_is_invariant_to_its_stabilizer``) and differ by
  rounding, well inside these bounds.

q, k and v come from distinct projections and the decode starts from a
random state, so a transposed matrix memory C fails.
"""
import functools
import importlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.configs.base import MLSTM, SLSTM
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ssm_scan as ssm_k
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import ssm
from repro_torch.models import transformer as tr
from repro_torch.serving import ServeEngine, ServeRequest

ARCH = "xlstm-1.3b"
REPO_ROOT = __file__.rsplit("/tests/", 1)[0]
MIXER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jref():
    names = {"configs": "repro.configs", "ssm": "repro.models.ssm",
             "tr": "repro.models.transformer", "serving": "repro.serving"}
    return SimpleNamespace(**{k: importlib.import_module(v)
                              for k, v in names.items()})


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's ``init_lm`` weights of the smoke config, numpy."""
    import jax

    jtr = importlib.import_module("repro.models.transformer")
    jconfigs = importlib.import_module("repro.configs")
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_arch(ARCH))
    return jax.tree.map(np.asarray, jtr.init_lm(jax.random.PRNGKey(0), jcfg))


def _cfgs(jref):
    jcfg = jref.configs.reduce_for_smoke(jref.configs.get_arch(ARCH))
    cfg = reduce_for_smoke(get_arch(ARCH))
    assert cfg.pattern() == jcfg.pattern() == (MLSTM, SLSTM)
    return jcfg, cfg


def _mixer(kind):
    """(jax params, port params) of the smoke model's ``kind`` mixer: the
    reference's own init of layer 0 (mLSTM) or 1 (sLSTM)."""
    import jax.numpy as jnp

    j = 0 if kind == "mlstm" else 1
    tree = {k: np.asarray(a)[0] for k, a in _weights()["unit"][j][kind]
            .items()}
    return ({k: jnp.asarray(a) for k, a in tree.items()},
            {k: torch.from_numpy(a.copy()) for k, a in tree.items()})


def _x(S, d=256, seed=0, B=2):
    return (np.random.RandomState(seed).randn(B, S, d) * 0.5).astype(
        np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture
def mlstm_chunk(jref, monkeypatch):
    """Sets ``MLSTM_CHUNK`` in both packages."""
    def set_chunk(chunk):
        monkeypatch.setattr(jref.ssm, "MLSTM_CHUNK", chunk)
        monkeypatch.setattr(ssm, "MLSTM_CHUNK", chunk)
    return set_chunk


# ---------------------------------------------------------------------------
# init and weights
def test_init_shapes_match_reference(jref):
    """The port's own random init has the reference's tree, shapes and
    dtypes: mLSTM up_proj (d, 4d), wq/wk/wv (2d, 2d); no ln2 (no FFN)."""
    import jax

    _, cfg = _cfgs(jref)
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    got = jax.tree_util.tree_flatten_with_path(tr.lm_params_to_numpy(
        params, cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(_weights())[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
    m = params["layers"][0]["mlstm"]
    assert m["up_proj"].shape == (256, 1024) and m["wq"].shape == (512, 512)
    assert "ln2" not in params["layers"][0] and "ln2" not in params[
        "layers"][1]
    s = params["layers"][1]["slstm"]["bias"]
    assert s[512:768].eq(3.0).all() and s[:512].eq(0).all() and s[768:].eq(
        0).all()


def test_full_width_shapes(jref, monkeypatch):
    """The full-width config keeps the reference's shapes: an mLSTM head
    dim of 2d / 4 = 1,024, [7 x mLSTM, sLSTM] x 6, and the reference's
    ~3.60 B parameters (its tree by ``jax.eval_shape``; the port's mixers
    drawn as shapes only, on the meta device)."""
    import jax

    cfg = get_arch(ARCH)
    unit, groups = tr.factor_pattern(cfg.pattern())
    assert unit == (MLSTM,) * 7 + (SLSTM,) and groups == 6
    jcfg = jref.configs.get_arch(ARCH)
    jtree = jax.eval_shape(lambda k: jref.tr.init_lm(k, jcfg),
                           jax.random.PRNGKey(0))
    monkeypatch.setattr(ssm, "dense_init", lambda gen, shape, **kw: (
        torch.empty(shape, dtype=kw.get("dtype", torch.float32),
                    device="meta")))
    for kind, init in (("mlstm", ssm.init_mlstm), ("slstm", ssm.init_slstm)):
        j = unit.index(kind)
        want = {k: tuple(a.shape[1:]) for k, a in jtree["unit"][j][kind]
                .items()}
        got = {k: tuple(t.shape) for k, t in init(torch.Generator(), cfg)
               .items()}
        assert got == want, kind
    assert tuple(jtree["unit"][0]["mlstm"]["wq"].shape) == (6, 4096, 4096)
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jtree))
    assert 3.59e9 < n < 3.61e9
    assert ssm.mlstm_state_init(cfg, 8, torch.bfloat16, device="meta")[
        "C"].shape == (8, 4, 1024, 1024)


def test_lm_params_round_trip(jref):
    _, cfg = _cfgs(jref)
    import jax

    tree = _weights()
    params = tr.lm_params_from_numpy(tree, cfg, device="cpu")
    back = tr.lm_params_to_numpy(params, cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        params["layers"][1]["slstm"]["w_rec"].numpy(),
        tree["unit"][1]["slstm"]["w_rec"][0])


# ---------------------------------------------------------------------------
# the mixers
def test_log_sigmoid_is_jax_s():
    """``jax.nn.log_sigmoid`` is ``-softplus(-x)`` with softplus as
    ``logaddexp(x, 0)``; the port's matches it to an f32 rounding over
    the whole range (values below f32's normal range, ~1.2e-38, may
    flush to zero in one framework and not the other)."""
    import jax

    x = np.concatenate([np.linspace(-120, 120, 4001),
                        [-1e4, -88.8, 17.5, 30.0, 1e4]]).astype(np.float32)
    _close(ssm.log_sigmoid(torch.from_numpy(x)), jax.nn.log_sigmoid(x),
           atol=1.2e-38, rtol=2e-7)


@pytest.mark.parametrize("S,chunk", [(12, 512), (64, 8), (64, 32),
                                     (100, 512), (20, 8)])
def test_mlstm_scan_matches_reference(jref, mlstm_chunk, S, chunk):
    """S = 12: one chunk; S = 64 in chunks of 8 and 32 (the reference's
    own test's shapes); S = 100 and S = 20 take the gcd path (chunks of 4,
    from a chunk length of 512 and of 8)."""
    import jax.numpy as jnp

    mlstm_chunk(chunk)
    jcfg, cfg = _cfgs(jref)
    jp, p = _mixer("mlstm")
    x = _x(S, seed=S)
    want = jref.ssm.mlstm_scan(jp, jnp.asarray(x), jcfg)
    got = ssm.mlstm_scan(p, torch.from_numpy(x), cfg)
    assert got.shape == (2, S, 256)
    _close(got, want, **MIXER_TOL)


@pytest.mark.parametrize("S", [12, 256])
def test_mlstm_scan_sequential_matches_reference(jref, S):
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(jref)
    jp, p = _mixer("mlstm")
    x = _x(S, seed=S + 1)
    _close(ssm.mlstm_scan_sequential(p, torch.from_numpy(x), cfg),
           jref.ssm.mlstm_scan_sequential(jp, jnp.asarray(x), jcfg),
           **MIXER_TOL)


@pytest.mark.parametrize("chunk", [8, 32])
def test_mlstm_chunkwise_matches_sequential(jref, mlstm_chunk, chunk):
    """The port's chunkwise prefill against its own sequential form, at
    the reference's bound for the same check."""
    _, cfg = _cfgs(jref)
    mlstm_chunk(chunk)
    _, p = _mixer("mlstm")
    x = torch.from_numpy(_x(64, seed=3))
    par = ssm.mlstm_scan(p, x, cfg)
    seq = ssm.mlstm_scan_sequential(p, x, cfg)
    torch.testing.assert_close(par, seq, atol=3e-4, rtol=3e-4)


def _random_mlstm_state(B=2, H=4, hd=128, seed=7):
    rng = np.random.RandomState(seed)
    return {"C": (rng.randn(B, H, hd, hd) * 0.1).astype(np.float32),
            "n": (rng.randn(B, H, hd) * 0.1).astype(np.float32),
            "m": rng.randn(B, H).astype(np.float32)}


def test_mlstm_decode_matches_reference(jref):
    """Five decode steps from a random, non-symmetric state C (q, k and v
    distinct), then five from ``mlstm_state_init``: output and state."""
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(jref)
    jp, p = _mixer("mlstm")
    init = ssm.mlstm_state_init(cfg, 2, torch.float32, device="cpu")
    jinit = jref.ssm.mlstm_state_init(jcfg, 2, jnp.float32)
    assert float(init["m"][0, 0]) == float(jinit["m"][0, 0]) == -1e9
    for start in (_random_mlstm_state(), {k: v.numpy() for k, v in
                                          init.items()}):
        state = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
        jstate = {k: jnp.asarray(v) for k, v in start.items()}
        for t in range(5):
            x = _x(1, seed=10 + t)
            want, jstate = jref.ssm.mlstm_decode(jp, jnp.asarray(x), jstate,
                                                 jcfg)
            got, state = ssm.mlstm_decode(p, torch.from_numpy(x), state, cfg)
            _close(got, want, **MIXER_TOL)
            for k in ("C", "n", "m"):
                _close(state[k], jstate[k], **MIXER_TOL)


def test_mlstm_state_is_invariant_to_its_stabilizer(jref):
    """A state (C, n, m) and (C e^-d, n e^-d, m + d) hold the same memory:
    the stabilizer scales the numerator and both terms of the
    denominator's ``max(|q . n|, exp(-m))`` alike, so a decode step from
    either gives one output (to f32 rounding), whichever m it started
    from.  This is why the chunkwise form's m0 = 0 and the sequential
    form's m0 = -1e9 compute one function."""
    _, cfg = _cfgs(jref)
    _, p = _mixer("mlstm")
    start = _random_mlstm_state()
    x = torch.from_numpy(_x(1, seed=30))
    outs = []
    for shift in (0.0, 3.0, -7.0):
        scale = np.float32(np.exp(-shift))
        st = {"C": torch.from_numpy(start["C"] * scale),
              "n": torch.from_numpy(start["n"] * scale),
              "m": torch.from_numpy(start["m"] + np.float32(shift))}
        outs.append(ssm.mlstm_decode(p, x, st, cfg)[0])
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [12, 512])
def test_slstm_scan_matches_reference(jref, S):
    """S = 512 runs two of the reference's 256-step scan chunks."""
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(jref)
    jp, p = _mixer("slstm")
    x = _x(S, seed=S + 2)
    _close(ssm.slstm_scan(p, torch.from_numpy(x), cfg),
           jref.ssm.slstm_scan(jp, jnp.asarray(x), jcfg), **MIXER_TOL)


def test_slstm_decode_matches_reference(jref):
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(jref)
    jp, p = _mixer("slstm")
    rng = np.random.RandomState(9)
    start = {k: rng.randn(2, 256).astype(np.float32) * 0.5
             for k in ("h", "c", "m")}
    start["n"] = np.abs(start["c"]) + 0.5
    state = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    jstate = {k: jnp.asarray(v) for k, v in start.items()}
    for t in range(6):
        x = _x(1, seed=20 + t)
        want, jstate = jref.ssm.slstm_decode(jp, jnp.asarray(x), jstate, jcfg)
        got, state = ssm.slstm_decode(p, torch.from_numpy(x), state, cfg)
        _close(got, want, **MIXER_TOL)
        for k in "hcnm":
            _close(state[k], jstate[k], **MIXER_TOL)
    init = ssm.slstm_state_init(cfg, 2, torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.float32 for t in init.values())
    assert init["m"].eq(-1e9).all() and not init["h"].any()


def test_scan_chunked_contract_raises_where_the_reference_asserts(jref):
    """S = 300 is not a multiple of min(256, S): the reference's
    ``scan_chunked`` asserts, the port raises ``ValueError``, in both
    sequential forms.  S = 256 and S = 12 pass."""
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(jref)
    x = _x(300, seed=1)
    for kind, fn in (("slstm", "slstm_scan"),
                     ("mlstm", "mlstm_scan_sequential")):
        jp, p = _mixer(kind)
        with pytest.raises(AssertionError):
            getattr(jref.ssm, fn)(jp, jnp.asarray(x), jcfg)
        with pytest.raises(ValueError, match="multiple of the scan chunk"):
            getattr(ssm, fn)(p, torch.from_numpy(x), cfg)
    carry, ys = ssm.scan_chunked(lambda c, x: (c + x[0], c), torch.zeros(()),
                                 (torch.arange(12.),), 256)
    assert float(carry) == 66 and ys.tolist() == [
        sum(range(t)) for t in range(12)]


# ---------------------------------------------------------------------------
# the model
def _both(jref):
    import jax
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(jref)
    tree = _weights()
    return (jax.tree.map(jnp.asarray, tree),
            tr.lm_params_from_numpy(tree, cfg, device="cpu"), jcfg, cfg)


@pytest.mark.parametrize("S", [12, 64, 256])
def test_forward_logits_match_reference(jref, S):
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref)
    toks = np.random.RandomState(S).randint(0, cfg.vocab_size, (2, S))
    want, _ = jref.tr.forward_logits(jparams, {"tokens": jnp.asarray(toks)},
                                     jcfg)
    for mod in (fa_k, dec_k, ssm_k):
        mod.reset_launch_counts()
    got, aux = tr.forward_logits(params, {"tokens": torch.from_numpy(toks)},
                                 cfg)
    assert got.shape == (2, S, cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want, **MODEL_TOL)
    assert fa_k.LAUNCHES["flash_attention"] == 0
    assert ssm_k.LAUNCHES["ssm_scan"] == 0


def test_decode_steps_match_reference(jref):
    """Ten decode steps: logits and every layer's recurrent state."""
    import jax
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref)
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 10))
    jstate = jref.tr.init_decode_state(jcfg, 2, 16, jnp.float32)
    state = tr.init_decode_state(cfg, 2, 16, torch.float32, device="cpu")
    assert "memory" not in state and "memory" not in jstate
    jstep = jax.jit(lambda p, s, t, i: jref.tr.decode_step(p, s, t, i, jcfg))
    step = make_decode_step(cfg)
    for t in range(10):
        want, jstate = jstep(jparams, jstate, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(t))
        got, state = step(params, state, torch.from_numpy(toks[:, t:t + 1]),
                          t)
        _close(got, want, **MODEL_TOL)
    for j, kind in enumerate(("mlstm", "slstm")):
        for name, v in state["layers"][j][kind].items():
            _close(v, jstate["layers"][j][kind][name][0], **MODEL_TOL)


def test_prefill_matches_token_by_token_decode(jref):
    """Inside the port, at the reference's own bound (5e-4): the prefill
    (chunkwise, m0 = 0) against the decode (sequential, m0 = -1e9); the
    measured worst is ~3e-6."""
    _, params, _, cfg = _both(jref)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 24)))
    full, _ = tr.forward_logits(params, {"tokens": toks}, cfg)
    last = make_prefill_step(cfg)(params, {"tokens": toks})
    torch.testing.assert_close(last, full[:, -1], atol=1e-6, rtol=1e-6)
    state = tr.init_decode_state(cfg, 2, 24, torch.float32, device="cpu")
    step = make_decode_step(cfg)
    for t in range(24):
        got, state = step(params, state, toks[:, t:t + 1], t)
        torch.testing.assert_close(got[:, 0], full[:, t], atol=5e-4,
                                   rtol=5e-4)


def test_serve_engine_greedy_tokens_equal_reference(jref):
    jparams, params, jcfg, cfg = _both(jref)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9)]
    new = (6, 8)
    jeng = jref.serving.ServeEngine(jparams, jcfg, batch=2, cache_len=16)
    want = jeng.generate([jref.serving.ServeRequest(prompt=p, max_new=m)
                          for p, m in zip(prompts, new)])
    for mod in (fa_k, dec_k, ssm_k):
        mod.reset_launch_counts()
    eng = ServeEngine(params, cfg, batch=2, cache_len=16, device="cpu")
    got = eng.generate([ServeRequest(prompt=p, max_new=m)
                        for p, m in zip(prompts, new)])
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert eng.steps == 9 + 8
    assert sum(dec_k.LAUNCHES.values()) + sum(fa_k.LAUNCHES.values()) == 0


def test_serve_cli_runs_the_smoke_model_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "2", "--max-new", "4"],
        cwd=REPO_ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}, check=True)
    assert "req 1: " in out.stdout and "8 tokens" in out.stdout
    assert "xlstm-1.3b-smoke on cpu" in out.stdout


def test_xlstm_spans_label_the_mixers_only_under_the_profiler(jref):
    """``profile_serve.span_times`` finds ``ssm.mlstm`` and ``ssm.slstm``
    once per layer of a prefill and of a decode step under
    ``torch.profiler``; outside it nothing is labelled."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.layers import span
    from repro_torch.profile_serve import span_times

    _, params, _, cfg = _both(jref)
    toks = torch.zeros((2, 8), dtype=torch.int64)
    state = tr.init_decode_state(cfg, 2, 4, torch.float32, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.forward_logits(params, {"tokens": toks}, cfg)
        tr.decode_step(params, state, toks[:, :1], 0, cfg)
    spans = span_times(prof.events(), ssm.XLSTM_SPANS)
    assert sorted(spans) == sorted(ssm.XLSTM_SPANS)
    assert all(host > 0 for _, host in spans.values())
    assert {n: sum(e.name == n for e in prof.events())
            for n in ssm.XLSTM_SPANS} == {n: 2 for n in ssm.XLSTM_SPANS}
    assert isinstance(span("ssm.mlstm"), contextlib.nullcontext)
