"""The Mamba mixer, the selective-scan kernel B6 and the Hymba serving path
of the port against the JAX reference on the CPU, at the smoke size
(``reduce_for_smoke``: 2 layers, d 256, 4/2 heads, head_dim 64, N 16,
vocab 1024, f32).  Both packages get the same numpy inputs and the
reference's own initial weights.

Tolerances:
* B6's plain version against the reference's Pallas kernel (interpret
  mode) and its oracle: abs/rel 1e-5, the reference's own bound between
  them (tests/test_kernels.py).  Both fold in time order; the measured
  worst is 2.4e-7 (one or two f32 roundings: the port rounds ``a_t * h``
  and ``+ b_t`` separately, XLA's CPU code need not).
* The Mamba mixer's parts, f32: abs/rel 1e-5.  The reference combines
  inside a chunk with ``associative_scan`` (a tree order), the port folds
  in time order (B6), so the states agree to f32 rounding, not bit for
  bit.
* The whole Hymba model: abs/rel 2e-5 on the logits, as for the
  attention-only models (test_torch_lm.py); measured worst ~6e-6 on
  logits of size ~4.
* Prefill against token-by-token decode inside the port: 5e-4, the
  reference's own bound for Hymba (tests/test_arch_smoke.py).

The reference's ``repro.models`` and ``repro.kernels`` import without the
``jax.core`` alias.
"""
import dataclasses
import functools
import importlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.configs.base import ATTN, MAMBA
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as ssm_k
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import ssm
from repro_torch.models import transformer as tr
from repro_torch.serving import ServeEngine, ServeRequest

REPO_ROOT = __file__.rsplit("/tests/", 1)[0]
SCAN_GRID = [(128, 64, 8, 32, 32), (256, 256, 16, 64, 128),
             (64, 128, 4, 64, 64)]      # tests/test_kernels.py::test_ssm_scan
MIXER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-5, rtol=2e-5)
# the Hymba smoke model, and one with a MAMBA block (d_in = 2 d) beside an
# attention block
MODELS = ["hymba", "mamba-attn"]


@pytest.fixture(scope="module")
def jref():
    names = {"configs": "repro.configs", "ssm": "repro.models.ssm",
             "tr": "repro.models.transformer", "serving": "repro.serving",
             "kref": "repro.kernels.ref", "kops": "repro.kernels.ops"}
    return SimpleNamespace(**{k: importlib.import_module(v)
                              for k, v in names.items()})


def _cfg(configs, model):
    cfg = configs.reduce_for_smoke(configs.get_arch("hymba-1.5b"))
    if model == "mamba-attn":
        cfg = dataclasses.replace(cfg, name="mamba-attn-smoke",
                                  block_kind=ATTN,
                                  block_pattern=(MAMBA, ATTN))
    return cfg


def _cfgs(jref, model):
    """(reference cfg, port cfg)."""
    jcfg = _cfg(jref.configs, model)
    cfg = _cfg(SimpleNamespace(get_arch=get_arch,
                               reduce_for_smoke=reduce_for_smoke), model)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _weights(model):
    """The reference's ``init_lm`` weights, as numpy."""
    import jax

    jconfigs = importlib.import_module("repro.configs")
    jtr = importlib.import_module("repro.models.transformer")
    params = jtr.init_lm(jax.random.PRNGKey(0), _cfg(jconfigs, model))
    return jax.tree.map(np.asarray, params)


def _both(jref, model):
    """(jax params, port params, reference cfg, port cfg)."""
    import jax
    import jax.numpy as jnp

    tree = _weights(model)
    jcfg, cfg = _cfgs(jref, model)
    return (jax.tree.map(jnp.asarray, tree),
            tr.lm_params_from_numpy(tree, cfg, device="cpu"), jcfg, cfg)


def _mixer(jref, d_in=256):
    """The reference's ``init_mamba`` weights (port and jax copies) with
    random conv bias, dt bias and skip ``D`` so every term is exercised."""
    import jax
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(jref, "hymba")
    tree = {k: np.asarray(v) for k, v in jref.ssm.init_mamba(
        jax.random.PRNGKey(1), jcfg, d_in).items()}
    rng = np.random.RandomState(1)
    tree["conv_b"] = (rng.randn(d_in) * 0.1).astype(np.float32)
    tree["dt_bias"] = (rng.randn(d_in) - 3.0).astype(np.float32)
    tree["D"] = rng.rand(d_in).astype(np.float32) + 0.5
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()}, jcfg,
            cfg)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               **(tol or MODEL_TOL))


def _scan_inputs(B, S, D, N, seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.2, 0.999, (B, S, D, N)).astype(np.float32)
    b = (rng.randn(B, S, D, N) * 0.1).astype(np.float32)
    h0 = rng.randn(B, D, N).astype(np.float32)
    return a, b, h0


# ---------------------------------------------------------------------------
# B6: the plain version against the reference's kernel and oracle
@pytest.mark.parametrize("S,D,N,chunk,bd", SCAN_GRID)
def test_ssm_scan_plain_matches_reference_kernel(jref, S, D, N, chunk, bd):
    """Through the port's dispatch on CPU tensors (the plain version), from
    h_0 = 0, against the Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    a, b, _ = _scan_inputs(2, S, D, N, S + D)
    ssm_k.reset_launch_counts()
    got = ops.ssm_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert ssm_k.LAUNCHES["ssm_scan"] == 0
    assert got.dtype == torch.float32 and got.shape == a.shape
    want = jref.kops.ssm_scan(jnp.asarray(a), jnp.asarray(b),
                              impl="interpret", chunk=chunk, bd=bd)
    _close(got, want, **MIXER_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,D,N", [(128, 64, 8), (77, 100, 5)])
def test_ssm_scan_plain_with_h0_matches_oracle(jref, S, D, N, dtype):
    """A nonzero initial state, f32 and bf16 inputs (read as f32), and a
    shape that is a multiple of nothing."""
    import jax.numpy as jnp

    a, b, h0 = _scan_inputs(3, S, D, N, S)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    got = ssm_k.ssm_scan(ta, tb, torch.from_numpy(h0))
    assert got.dtype == torch.float32
    want = jref.kref.ssm_scan_ref(jnp.asarray(ta.float().numpy()).astype(
        getattr(jnp, dtype)), jnp.asarray(tb.float().numpy()).astype(
        getattr(jnp, dtype)), jnp.asarray(h0))
    _close(got, want, **MIXER_TOL)
    zero = ref.ssm_scan_ref(ta, tb, torch.zeros_like(torch.from_numpy(h0)))
    assert torch.equal(ref.ssm_scan_ref(ta, tb), zero)


def _scan_args(shape=(2, 8, 4, 3), dtype=torch.float32):
    a = torch.zeros(shape, dtype=dtype)
    return a, a.clone(), torch.zeros((shape[0], shape[2], shape[3]))


@pytest.mark.parametrize("change,exc,match", [
    (lambda a, b, h0: (a, b, h0), ValueError, "CUDA"),
    (lambda a, b, h0: (a, b, None), ValueError, "CUDA"),
    (lambda a, b, h0: (a.double(), b.double(), h0), TypeError, "float32"),
    (lambda a, b, h0: (a, b.bfloat16(), h0), TypeError, "bfloat16"),
    (lambda a, b, h0: (a, b[:, :4], h0), ValueError, "one shape"),
    (lambda a, b, h0: (a[0], b[0], h0), ValueError, "one shape"),
    (lambda a, b, h0: (a[:, :0], b[:, :0], h0), ValueError, "range"),
    (lambda a, b, h0: (a, b, h0[:1]), ValueError, "h0"),
    (lambda a, b, h0: (a, b, h0.bfloat16()), ValueError, "h0"),
    (lambda a, b, h0: (a.transpose(2, 3).contiguous().transpose(2, 3), b,
                       h0), ValueError, "contiguous"),
    (lambda a, b, h0: (a, b, h0.transpose(1, 2).contiguous().transpose(
        1, 2)), ValueError, "contiguous"),
])
def test_ssm_scan_checks_raise(change, exc, match):
    """The wrapper's checks (run for CUDA tensors): on the CPU every valid
    input gets as far as the device check."""
    a, b, h0 = change(*_scan_args())
    with pytest.raises(exc, match=match):
        ssm_k.check_args(a, b, h0)


def test_ssm_scan_on_cpu_is_the_plain_version_and_launches_nothing():
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 9, 5, 3, 0))
    ssm_k.reset_launch_counts()
    assert torch.equal(ops.ssm_scan(a, b, h0), ref.ssm_scan_ref(a, b, h0))
    assert torch.equal(ops.ssm_scan(a, b), ref.ssm_scan_ref(a, b))
    assert ssm_k.LAUNCHES["ssm_scan"] == 0


# ---------------------------------------------------------------------------
# the Mamba mixer's parts
def test_causal_conv_matches_reference(jref):
    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 256).astype(np.float32)
    w = rng.randn(ssm.CONV_WIDTH, 256).astype(np.float32)
    b = rng.randn(256).astype(np.float32)
    _close(ssm._causal_conv(*(torch.from_numpy(t) for t in (x, w, b))),
           jref.ssm._causal_conv(*(jnp.asarray(t) for t in (x, w, b))),
           atol=1e-6, rtol=1e-6)


def test_mamba_coeffs_match_reference(jref):
    import jax.numpy as jnp

    jp, p, jcfg, cfg = _mixer(jref)
    u = np.random.RandomState(3).randn(2, 9, 256).astype(np.float32)
    got = ssm._mamba_coeffs(p, torch.from_numpy(u), cfg)
    want = jref.ssm._mamba_coeffs(jp, jnp.asarray(u), jcfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w, **MIXER_TOL)
    a, b, _ = got
    assert a.is_contiguous() and b.is_contiguous()   # what B6 takes
    with pytest.raises(ValueError, match="CUDA"):
        ssm_k.check_args(a, b, torch.zeros(a.shape[0], *a.shape[2:]))


def test_softplus_is_jax_softplus():
    """``logaddexp(x, 0)`` as ``jax.nn.softplus``, also above 20, where
    ``F.softplus`` returns x itself."""
    import jax

    x = np.array([-100.0, -20.0, -1.0, 0.0, 1.0, 19.0, 21.0, 40.0, 1e4],
                 np.float32)
    _close(ssm.softplus(torch.from_numpy(x)), jax.nn.softplus(x),
           atol=1e-30, rtol=2e-7)


@pytest.mark.parametrize("S", [8, 128, 200])
def test_mamba_scan_matches_reference(jref, S):
    """Inside one chunk, exactly one chunk, and across a chunk boundary with
    padding: one B6 call per chunk, h carried between them."""
    import jax.numpy as jnp

    jp, p, jcfg, cfg = _mixer(jref)
    x = np.random.RandomState(S).randn(2, S, 256).astype(np.float32)
    calls = []
    real = ops.ssm_scan

    def spy(a, b, h0=None):
        calls.append((tuple(a.shape), None if h0 is None else
                      tuple(h0.shape)))
        return real(a, b, h0)

    ops.ssm_scan = spy
    try:
        got = ssm.mamba_scan(p, torch.from_numpy(x), cfg)
    finally:
        ops.ssm_scan = real
    want = jref.ssm.mamba_scan(jp, jnp.asarray(x), jcfg)
    assert got.shape == (2, S, 256)
    _close(got, want, **MIXER_TOL)
    chunk = min(ssm.MAMBA_CHUNK, S)
    n = -(-S // chunk)
    assert calls == [((2, chunk, 256, 16), None if c == 0 else (2, 256, 16))
                     for c in range(n)]


def test_mamba_decode_steps_match_reference(jref):
    import jax.numpy as jnp

    jp, p, jcfg, cfg = _mixer(jref)
    xs = np.random.RandomState(4).randn(6, 2, 1, 256).astype(np.float32)
    jstate = jref.ssm.mamba_state_init(jcfg, 2, 256, jnp.float32)
    state = ssm.mamba_state_init(cfg, 2, 256, torch.float32)
    h_buf = state["h"]
    for x in xs:
        want, jstate = jref.ssm.mamba_decode(jp, jnp.asarray(x), jstate,
                                             jcfg)
        got, state = ssm.mamba_decode(p, torch.from_numpy(x), state, cfg)
        _close(got, want, **MIXER_TOL)
        _close(state["h"], jstate["h"], **MIXER_TOL)
        _close(state["conv"], jstate["conv"], **MIXER_TOL)
    assert state["h"] is h_buf          # updated in place


# ---------------------------------------------------------------------------
# the model
def test_hymba_and_mamba_are_ported(jref):
    for model in MODELS:
        _, cfg = _cfgs(jref, model)
        tr.check_ported(cfg)
    tr.check_ported(get_arch("hymba-1.5b"))


@pytest.mark.parametrize("model", MODELS)
def test_lm_params_round_trip_carries_mamba(jref, model):
    import jax

    tree = _weights(model)
    _, cfg = _cfgs(jref, model)
    params = tr.lm_params_from_numpy(tree, cfg, device="cpu")
    back = tr.lm_params_to_numpy(params, cfg)
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_b, flat_t):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    mamba = [k for p, _ in flat_t for k in map(str, p) if "mamba" in k]
    assert mamba


@pytest.mark.parametrize("model", MODELS)
def test_init_shapes_match_reference(jref, model):
    """The port's own random init has the reference's tree, shapes and
    dtypes, Mamba leaves included."""
    import jax

    _, cfg = _cfgs(jref, model)
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    got = jax.tree_util.tree_flatten_with_path(
        tr.lm_params_to_numpy(params, cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(_weights(model))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path


@pytest.mark.parametrize("model,S", [("hymba", 16), ("hymba", 200),
                                     ("mamba-attn", 150)])
def test_forward_logits_match_reference(jref, model, S):
    """S = 200 and 150 cross the 128-step chunk and need padding."""
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref, model)
    toks = np.random.RandomState(S).randint(0, cfg.vocab_size, (2, S))
    want, _ = jref.tr.forward_logits(jparams, {"tokens": jnp.asarray(toks)},
                                     jcfg)
    fa_k.reset_launch_counts()
    ssm_k.reset_launch_counts()
    got, aux = tr.forward_logits(params, {"tokens": torch.from_numpy(toks)},
                                 cfg)
    assert got.shape == (2, S, cfg.padded_vocab) and float(aux) == 0.0
    assert fa_k.LAUNCHES["flash_attention"] == 0
    assert ssm_k.LAUNCHES["ssm_scan"] == 0
    _close(got, want)


def test_prefill_step_is_the_last_position(jref):
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref, "hymba")
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (3, 20))
    got = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(toks)})
    x, _ = jref.tr.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    want = jref.tr.lm_logits(jparams["embed"], x[:, -1:], jcfg)[:, 0]
    assert got.shape == (3, cfg.padded_vocab)
    _close(got, want)


@pytest.mark.parametrize("model,cache_len,window,steps", [
    ("hymba", 16, 0, 10),       # full cache
    ("hymba", 16, 8, 12),       # ring buffer of 8 slots, wrapped
    ("mamba-attn", 16, 0, 10),
])
def test_decode_steps_match_reference(jref, model, cache_len, window,
                                      steps):
    import jax
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref, model)
    toks = np.random.RandomState(steps).randint(0, cfg.vocab_size,
                                                (2, steps))
    jstate = jref.tr.init_decode_state(jcfg, 2, cache_len, jnp.float32,
                                       window=window)
    state = tr.init_decode_state(cfg, 2, cache_len, torch.float32,
                                 window=window, device="cpu")
    jstep = jax.jit(functools.partial(jref.tr.decode_step, cfg=jcfg,
                                      window=window))
    step = make_decode_step(cfg, window)
    for t in range(steps):
        want, jstate = jstep(jparams, jstate, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(t))
        got, state = step(params, state, torch.from_numpy(toks[:, t:t + 1]),
                          t)
        assert got.shape == (2, 1, cfg.padded_vocab)
        _close(got, want)
    unit, _ = tr.factor_pattern(cfg.pattern())
    for i, layer in enumerate(state["layers"]):
        j, g = i % len(unit), i // len(unit)
        want = jstate["layers"][j]
        assert sorted(layer) == sorted(want)
        for name in ("k", "v"):
            if name in layer:
                _close(layer[name], want[name][g])
        if "mamba" in layer:
            assert layer["mamba"]["h"].dtype == torch.float32
            for name in ("h", "conv"):
                _close(layer["mamba"][name], want["mamba"][name][g],
                       **MIXER_TOL)


@pytest.mark.parametrize("model", MODELS)
def test_prefill_matches_token_by_token_decode(jref, model):
    """The port's own consistency: the whole prompt through the prefill
    forward (B6 over two chunks, the second padded) against the same
    tokens fed one by one through the decode step."""
    _, params, _, cfg = _both(jref, model)
    S = 140
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab_size, (1, S)))
    full, _ = tr.forward_logits(params, {"tokens": toks}, cfg)
    state = tr.init_decode_state(cfg, 1, S, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        logits, state = tr.decode_step(params, state, toks[:, t:t + 1], t,
                                       cfg)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, atol=5e-4,
                               rtol=5e-4)


def test_serve_engine_greedy_tokens_equal_reference(jref):
    """Two greedy requests; the second's prompt + max_new (12 + 10) runs
    past cache_len = 16.  The engine's decode path runs no B6."""
    jparams, params, jcfg, cfg = _both(jref, "hymba")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12)]
    new = (6, 10)
    jeng = jref.serving.ServeEngine(jparams, jcfg, batch=2, cache_len=16)
    want = jeng.generate([jref.serving.ServeRequest(prompt=p, max_new=m)
                          for p, m in zip(prompts, new)])
    for mod in (fa_k, dec_k, ssm_k):
        mod.reset_launch_counts()
    eng = ServeEngine(params, cfg, batch=2, cache_len=16, device="cpu")
    got = eng.generate([ServeRequest(prompt=p, max_new=m)
                        for p, m in zip(prompts, new)])
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert eng.steps == 12 + 10
    assert (fa_k.LAUNCHES, dec_k.LAUNCHES, ssm_k.LAUNCHES) == (
        {"flash_attention": 0, "flash_attention_bwd": 0},
        {"decode_attention": 0}, {"ssm_scan": 0, "ssm_scan_bwd": 0})


def test_serve_cli_runs_the_hymba_smoke_model_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hymba-1.5b", "--smoke", "--device", "cpu", "--requests", "2",
         "--max-new", "4"], cwd=REPO_ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}, check=True)
    assert "hymba-1.5b-smoke on cpu: 8 tokens" in out.stdout
    assert "req 1: " in out.stdout
