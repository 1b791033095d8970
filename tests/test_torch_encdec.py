"""The encoder-decoder (SeamlessM4T-medium) and the VLM frontend
(LLaVA-NeXT-Mistral-7B) in the port against the JAX reference on the CPU,
at the smoke size (``reduce_for_smoke``: 2 layers, 2 encoder layers for
SeamlessM4T, d 256, 4 heads (2 KV heads for LLaVA), 16 frames or patches,
vocab 1024, f32).  Both packages get the same numpy inputs and the
reference's own initial weights.

Tolerances:
* ``cross_attention`` (B4 without the mask for Sq > 1, B5 over the whole
  memory for Sq = 1; here their plain versions) and ``encode``: abs/rel
  1e-5 (``MIXER_TOL``);
* whole-model logits: abs/rel 2e-5 (``MODEL_TOL``, as in
  test_torch_lm.py); greedy ``ServeEngine`` tokens equal;
* the port's prefill against its own token-by-token decode: 2e-4, the
  reference's bound for attention models (tests/test_arch_smoke.py).

The reference's engine never fills ``memory``: it stays at the zeros of
``init_decode_state``.  A caller that wants an encoded memory sets
``state["memory"] = encode(...)``, as the reference's own test does
(tests/test_arch_smoke.py::test_decode_step); both are held here.
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
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      prefill_inputs, text_len)
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tr
from repro_torch.serving import ServeEngine, ServeRequest

SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-mistral-7b"
ARCHS = [SEAMLESS, LLAVA]
REPO_ROOT = __file__.rsplit("/tests/", 1)[0]
MIXER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jref():
    names = {"configs": "repro.configs", "attn": "repro.models.attention",
             "layers": "repro.models.layers",
             "tr": "repro.models.transformer", "serving": "repro.serving"}
    return SimpleNamespace(**{k: importlib.import_module(v)
                              for k, v in names.items()})


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's ``init_lm`` weights of the smoke config, numpy."""
    import jax

    jtr = importlib.import_module("repro.models.transformer")
    jconfigs = importlib.import_module("repro.configs")
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_arch(arch))
    return jax.tree.map(np.asarray, jtr.init_lm(jax.random.PRNGKey(0), jcfg))


def _both(jref, arch):
    """(jax params, port params, reference cfg, port cfg)."""
    import jax
    import jax.numpy as jnp

    tree = _weights(arch)
    jcfg = jref.configs.reduce_for_smoke(jref.configs.get_arch(arch))
    cfg = reduce_for_smoke(get_arch(arch))
    return (jax.tree.map(jnp.asarray, tree),
            tr.lm_params_from_numpy(tree, cfg, device="cpu"), jcfg, cfg)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _inputs(cfg, S, seed, B=2):
    """numpy prefill inputs: S text tokens and the frontend's embeddings
    (a VLM's prefix or an encoder-decoder's frames)."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (B, S))}
    name = "enc_embeds" if cfg.n_enc_layers else "frontend_embeds"
    out[name] = rng.randn(B, cfg.frontend_tokens, cfg.d_model).astype(
        np.float32)
    return out


def _jax(inputs):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _memory(jref, arch, seed=11, B=2):
    """(reference memory, port memory) encoded from the same frames."""
    jparams, params, jcfg, cfg = _both(jref, arch)
    frames = np.random.RandomState(seed).randn(
        B, cfg.frontend_tokens, cfg.d_model).astype(np.float32)
    import jax.numpy as jnp
    return (jref.tr.encode(jparams, jnp.asarray(frames), jcfg),
            tr.encode(params, torch.from_numpy(frames), cfg))


# ---------------------------------------------------------------------------
# init and weights
@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_match_reference(jref, arch):
    """The port's own random init has the reference's tree, shapes and
    dtypes: ``frontend_proj``, and for SeamlessM4T ``enc_unit``,
    ``enc_norm`` and every decoder layer's ``ln_cross``/``cross``."""
    import jax

    cfg = reduce_for_smoke(get_arch(arch))
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    got = jax.tree_util.tree_flatten_with_path(tr.lm_params_to_numpy(
        params, cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(_weights(arch))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
    assert params["frontend_proj"].shape == (256, 256)
    assert not any(p.requires_grad for p in params.parameters())
    names = {n for n, _ in params.named_parameters()}
    assert "frontend_proj" in names
    if arch == SEAMLESS:
        assert len(params["enc_unit"]) == cfg.n_enc_layers == 2
        assert all("cross" not in p for p in params["enc_unit"])
        assert all("cross" in p and "ln_cross" in p
                   for p in params["layers"])
    else:
        assert "enc_unit" not in params and "cross" not in params[
            "layers"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip(jref, arch):
    import jax

    cfg = reduce_for_smoke(get_arch(arch))
    tree = _weights(arch)
    params = tr.lm_params_from_numpy(tree, cfg, device="cpu")
    back = tr.lm_params_to_numpy(params, cfg)
    assert sorted(back) == sorted(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    again = tr.lm_params_from_numpy(back, cfg, device="cpu")
    for (n, a), (_, b) in zip(params.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    if arch == SEAMLESS:
        np.testing.assert_array_equal(
            params["enc_unit"][1]["attn"]["wq"].numpy(),
            tree["enc_unit"]["attn"]["wq"][1])


def test_text_len_and_prefill_inputs():
    """LLaVA's text is ``seq_len - frontend_tokens`` beside a prefix of
    patches; SeamlessM4T's tokens are all text, its frames go to the
    encoder; xLSTM has no frontend."""
    llava, seamless = get_arch(LLAVA), get_arch(SEAMLESS)
    assert text_len(llava, 4096) == 1216
    assert text_len(seamless, 4096) == 4096
    assert text_len(get_arch("xlstm-1.3b"), 4096) == 4096
    gen = torch.Generator().manual_seed(0)
    for arch, name in ((SEAMLESS, "enc_embeds"), (LLAVA, "frontend_embeds")):
        cfg = reduce_for_smoke(get_arch(arch))
        inp = prefill_inputs(cfg, 3, 40, gen)
        assert sorted(inp) == sorted(["tokens", name])
        assert inp[name].shape == (3, 16, 256)
        assert inp[name].dtype == torch.float32
        assert inp["tokens"].shape == (3, text_len(cfg, 40))
        assert int(inp["tokens"].max()) < cfg.vocab_size
    bf = prefill_inputs(llava, 1, 2890, gen)
    assert bf["frontend_embeds"].dtype == torch.bfloat16
    assert bf["tokens"].shape == (1, 10)


@pytest.mark.parametrize("arch,frontend", [(SEAMLESS, None), (LLAVA, None),
                                           ("xlstm-1.3b", None),
                                           (SEAMLESS, "none")])
def test_prefill_inputs_match_reference_struct(jref, arch, frontend):
    """``prefill_inputs`` has the keys, shapes and embedding dtype of the
    reference's ``prefill_inputs_struct``, also for an encoder-decoder
    without a frontend: its frames still go to the encoder."""
    import dataclasses

    import jax.core

    from test_torch_reference import install_jax_core_alias

    added = install_jax_core_alias()      # repro.launch imports analysis/
    try:
        jsteps = importlib.import_module("repro.launch.steps")
    finally:
        for name in added:
            delattr(jax.core, name)
    jcfg = jref.configs.reduce_for_smoke(jref.configs.get_arch(arch))
    cfg = reduce_for_smoke(get_arch(arch))
    if frontend is not None:
        jcfg = dataclasses.replace(jcfg, frontend=frontend)
        cfg = dataclasses.replace(cfg, frontend=frontend)
    want = jsteps.prefill_inputs_struct(
        jcfg, jsteps.InputShape("prefill", 40, 3, "prefill"))
    got = prefill_inputs(cfg, 3, 40, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        if name != "tokens":
            assert str(t.dtype).split(".")[-1] == str(want[name].dtype)


# ---------------------------------------------------------------------------
# cross-attention and the encoder
@pytest.mark.parametrize("Sq", [1, 12, 300])
def test_cross_attention_matches_reference(jref, Sq):
    """Sq = 1 is a decode step (B5's plain version over all 16 memory
    positions), Sq = 12 and 300 a prefill (B4's, no mask, Sq != Sk)."""
    import jax.numpy as jnp

    cfg = reduce_for_smoke(get_arch(SEAMLESS))
    jcfg = jref.configs.reduce_for_smoke(jref.configs.get_arch(SEAMLESS))
    p = {k: np.asarray(a)[0].copy() for k, a in _weights(SEAMLESS)["unit"]
         [0]["cross"].items()}
    rng = np.random.RandomState(Sq)
    x = rng.randn(2, Sq, 256).astype(np.float32)
    mem = rng.randn(2, 16, 256).astype(np.float32)
    for mod in (fa_k, dec_k):
        mod.reset_launch_counts()
    got = attn.cross_attention({k: torch.from_numpy(a) for k, a in
                                p.items()}, torch.from_numpy(x),
                               torch.from_numpy(mem), cfg)
    want = jref.attn.cross_attention({k: jnp.asarray(a) for k, a in
                                      p.items()}, jnp.asarray(x),
                                     jnp.asarray(mem), jcfg)
    assert got.shape == (2, Sq, 256)
    _close(got, want, **MIXER_TOL)
    assert fa_k.LAUNCHES["flash_attention"] == 0      # CPU: plain versions
    assert dec_k.LAUNCHES["decode_attention"] == 0


def test_cross_attention_on_cpu_runs_the_plain_versions(monkeypatch):
    """A prefill calls B4's wrapper with ``causal=False`` and Sq != Sk; a
    decode step B5's with ``length`` = Sk for every row."""
    cfg = reduce_for_smoke(get_arch(SEAMLESS))
    p = attn.init_attention(torch.Generator().manual_seed(0), cfg)
    calls = []
    real_fa, real_dec = fa_k.flash_attention, dec_k.decode_attention
    monkeypatch.setattr(fa_k, "flash_attention", lambda q, k, v, **kw: (
        calls.append(("flash", q.shape[1], k.shape[1], kw)) or
        real_fa(q, k, v, **kw)))
    monkeypatch.setattr(dec_k, "decode_attention", lambda q, k, v, length: (
        calls.append(("decode", length.tolist(), length.dtype)) or
        real_dec(q, k, v, length)))
    mem = torch.randn(3, 16, 256)
    attn.cross_attention(p, torch.randn(3, 5, 256), mem, cfg)
    attn.cross_attention(p, torch.randn(3, 1, 256), mem, cfg)
    assert calls == [("flash", 5, 16, {"causal": False, "window": 0}),
                     ("decode", [16, 16, 16], torch.int32)]


def test_encode_matches_reference(jref):
    ref_mem, mem = _memory(jref, SEAMLESS)
    assert mem.shape == (2, 16, 256) and mem.dtype == torch.float32
    _close(mem, ref_mem, **MIXER_TOL)


# ---------------------------------------------------------------------------
# the models
@pytest.mark.parametrize("arch,S", [(SEAMLESS, 12), (SEAMLESS, 300),
                                    (LLAVA, 12), (LLAVA, 300)])
def test_forward_logits_match_reference(jref, arch, S):
    """Logits of the text positions only; S = 300 passes the reference's
    Q_CHUNK = 256 (LLaVA: 316 positions with its prefix)."""
    jparams, params, jcfg, cfg = _both(jref, arch)
    inputs = _inputs(cfg, S, seed=S)
    want, _ = jref.tr.forward_logits(jparams, _jax(inputs), jcfg)
    got, aux = tr.forward_logits(params, _torch(inputs), cfg)
    assert got.shape == (2, S, cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want, **MODEL_TOL)


def test_llava_without_a_prefix_is_its_text_model(jref):
    """As in the reference, a VLM's forward without ``frontend_embeds``
    runs the tokens alone."""
    jparams, params, jcfg, cfg = _both(jref, LLAVA)
    toks = {"tokens": np.random.RandomState(1).randint(0, cfg.vocab_size,
                                                       (2, 10))}
    want, _ = jref.tr.forward_logits(jparams, _jax(toks), jcfg)
    got, _ = tr.forward_logits(params, _torch(toks), cfg)
    _close(got, want, **MODEL_TOL)


def test_prefill_step_is_the_last_text_position(jref):
    for arch in ARCHS:
        _, params, _, cfg = _both(jref, arch)
        inputs = _torch(_inputs(cfg, 20, seed=3))
        full, _ = tr.forward_logits(params, inputs, cfg)
        got = make_prefill_step(cfg)(params, inputs)
        assert got.shape == (2, cfg.padded_vocab)
        torch.testing.assert_close(got, full[:, -1], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch,with_memory", [(SEAMLESS, False),
                                              (SEAMLESS, True),
                                              (LLAVA, False)])
def test_decode_steps_match_reference(jref, arch, with_memory):
    """Ten decode steps, the memory the zeros of ``init_decode_state``
    (as the engines leave it) or ``encode``'s output."""
    import jax
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref, arch)
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 10))
    jstate = jref.tr.init_decode_state(jcfg, 2, 16, jnp.float32)
    state = tr.init_decode_state(cfg, 2, 16, torch.float32, device="cpu")
    if cfg.n_enc_layers:
        assert state["memory"].shape == (2, 16, 256)
        assert not state["memory"].any()
    else:
        assert "memory" not in state and "memory" not in jstate
    if with_memory:
        jstate["memory"], state["memory"] = _memory(jref, arch)
    jstep = jax.jit(lambda p, s, t, i: jref.tr.decode_step(p, s, t, i, jcfg))
    step = make_decode_step(cfg)
    for t in range(10):
        want, jstate = jstep(jparams, jstate, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(t))
        got, state = step(params, state, torch.from_numpy(toks[:, t:t + 1]),
                          t)
        _close(got, want, **MODEL_TOL)
    for i, layer in enumerate(state["layers"]):
        for name in ("k", "v"):
            _close(layer[name], jstate["layers"][0][name][i], **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_token_by_token_decode(jref, arch):
    """Inside the port: the prefill forward against the decode path fed
    the same text token by token, at the reference's bound for attention
    (2e-4).  SeamlessM4T's decode attends to ``encode`` of the prefill's
    frames; LLaVA's prefill runs without a prefix (the decode path has
    none)."""
    _, params, _, cfg = _both(jref, arch)
    inputs = _torch(_inputs(cfg, 12, seed=8))
    if not cfg.n_enc_layers:
        del inputs["frontend_embeds"]
    full, _ = tr.forward_logits(params, inputs, cfg)
    state = tr.init_decode_state(cfg, 2, 12, torch.float32, device="cpu")
    if cfg.n_enc_layers:
        state["memory"] = tr.encode(params, inputs["enc_embeds"], cfg)
    step = make_decode_step(cfg)
    for t in range(12):
        got, state = step(params, state, inputs["tokens"][:, t:t + 1], t)
        torch.testing.assert_close(got[:, 0], full[:, t], atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("arch,with_memory", [(SEAMLESS, False),
                                              (SEAMLESS, True),
                                              (LLAVA, False)])
def test_serve_engine_greedy_tokens_equal_reference(jref, arch, with_memory):
    """The engines as they come (memory zeros) and with the memory set
    from ``encode`` in both before ``generate``."""
    jparams, params, jcfg, cfg = _both(jref, arch)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9)]
    new = (6, 8)
    jeng = jref.serving.ServeEngine(jparams, jcfg, batch=2, cache_len=16)
    dec_k.reset_launch_counts()
    eng = ServeEngine(params, cfg, batch=2, cache_len=16, device="cpu")
    if with_memory:
        jeng.state["memory"], eng.state["memory"] = _memory(jref, arch)
    want = jeng.generate([jref.serving.ServeRequest(prompt=p, max_new=m)
                          for p, m in zip(prompts, new)])
    got = eng.generate([ServeRequest(prompt=p, max_new=m)
                        for p, m in zip(prompts, new)])
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert eng.steps == 9 + 8
    assert dec_k.LAUNCHES["decode_attention"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_smoke_model_on_the_cpu(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "2", "--max-new", "4"],
        cwd=REPO_ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}, check=True)
    assert "req 1: " in out.stdout and "8 tokens" in out.stdout
    assert f"{arch}-smoke on cpu" in out.stdout
