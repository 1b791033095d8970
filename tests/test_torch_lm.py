"""The LM serving path of the port against the JAX reference on the CPU, at
the smoke size (``reduce_for_smoke``: 2 layers, d 256, 4/2 heads,
head_dim 64, vocab 1024): layers, prefill forward, decode steps (full
cache, ring-buffer window, cache overflow), the weight carry-over, and
``ServeEngine`` greedy tokens.  Both packages get the same numpy inputs
and the reference's own initial weights.

Tolerances: layers 1e-6 abs/rel (one op each, f32); whole-model logits
2e-5 abs/rel — f32 sums in another order over d = 256, d_ff = 512 and
two layers (the measured worst is a few 1e-6 on logits of size ~1); the
attention core is the plain version, held to the reference's kernels in
test_torch_attention.py.  Greedy tokens must be equal.

The reference's ``repro.models.transformer`` and ``repro.serving`` import
without the ``jax.core`` alias.
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
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tr
from repro_torch.serving import ServeEngine, ServeRequest

ATOL = RTOL = 2e-5
REPO_ROOT = __file__.rsplit("/tests/", 1)[0]


@pytest.fixture(scope="module")
def jref():
    names = {"configs": "repro.configs", "layers": "repro.models.layers",
             "tr": "repro.models.transformer", "serving": "repro.serving"}
    return SimpleNamespace(**{k: importlib.import_module(v)
                              for k, v in names.items()})


def _cfgs(jref, arch):
    """(reference cfg, port cfg) of the smoke variant of ``arch``."""
    jcfg = jref.configs.reduce_for_smoke(jref.configs.get_arch(arch))
    cfg = reduce_for_smoke(get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's ``init_lm`` weights of the smoke variant, as numpy."""
    import jax

    jtr = importlib.import_module("repro.models.transformer")
    jconfigs = importlib.import_module("repro.configs")
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_arch(arch))
    params = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    return jax.tree.map(np.asarray, params)


def _both(jref, arch):
    """(jax params, port params, reference cfg, port cfg)."""
    import jax.numpy as jnp

    tree = _weights(arch)
    jcfg, cfg = _cfgs(jref, arch)
    import jax
    return (jax.tree.map(jnp.asarray, tree),
            tr.lm_params_from_numpy(tree, cfg, device="cpu"), jcfg, cfg)


def _close(got: torch.Tensor, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# layers
def test_layers_match_reference(jref):
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(jref, "gemma-7b")       # geglu, embedding scaling
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 256).astype(np.float32)
    scale = rng.rand(256).astype(np.float32) + 0.5
    tol = dict(atol=1e-6, rtol=1e-6)
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x), 1e-5),
           jref.layers.rmsnorm({"scale": jnp.asarray(scale)},
                               jnp.asarray(x), 1e-5), **tol)
    h = rng.randn(2, 5, 4, 64).astype(np.float32) * 3
    pos = np.array([[0, 1, 2, 300, 4095]] * 2, np.int32)
    _close(layers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                             1e4),
           jref.layers.apply_rope(jnp.asarray(h), jnp.asarray(pos), 1e4),
           atol=2e-6, rtol=2e-6)
    tok = (rng.randn(cfg.padded_vocab, 256) / 16).astype(np.float32)
    ids = rng.randint(0, 1024, (2, 5))
    _close(layers.embed({"tok": torch.from_numpy(tok)},
                        torch.from_numpy(ids), cfg),
           jref.layers.embed({"tok": jnp.asarray(tok)}, jnp.asarray(ids),
                             jcfg), **tol)
    _close(layers.lm_logits({"tok": torch.from_numpy(tok)},
                            torch.from_numpy(x), cfg),
           jref.layers.lm_logits({"tok": jnp.asarray(tok)}, jnp.asarray(x),
                                 jcfg), atol=1e-5, rtol=1e-5)
    for act in ("geglu", "swiglu", "gelu"):
        c = dataclasses.replace(cfg, ffn_act=act)
        jc = dataclasses.replace(jcfg, ffn_act=act)
        names = (("w_gate", "w_up", "w_down") if act != "gelu"
                 else ("w_in", "w_out"))
        w = {n: (rng.randn(*((512, 256) if n in ("w_down", "w_out")
                             else (256, 512))) * 0.05).astype(np.float32)
             for n in names}
        _close(layers.ffn({n: torch.from_numpy(a) for n, a in w.items()},
                          torch.from_numpy(x), c),
               jref.layers.ffn({n: jnp.asarray(a) for n, a in w.items()},
                               jnp.asarray(x), jc), atol=1e-5, rtol=1e-5)


def test_init_shapes_match_reference(jref):
    """The port's own random init has the reference's tree, shapes and
    dtypes."""
    _, cfg = _cfgs(jref, "phi3-medium-14b")     # untied head
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    got = tr.lm_params_to_numpy(params, cfg)
    import jax
    want = jax.tree.map(np.asarray, _weights("phi3-medium-14b"))
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.shape == w.shape and g.dtype == w.dtype, path
    assert not any(p.requires_grad for p in params.parameters())


def test_lm_params_round_trip(jref):
    tree = _weights("smollm-360m")
    _, cfg = _cfgs(jref, "smollm-360m")
    params = tr.lm_params_from_numpy(tree, cfg, device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    back = tr.lm_params_to_numpy(params, cfg)
    import jax
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    again = tr.lm_params_from_numpy(back, cfg, device="cpu")
    for (n, a), (_, b) in zip(params.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    np.testing.assert_array_equal(
        params["layers"][1]["attn"]["wq"].numpy(), tree["unit"][0]["attn"]
        ["wq"][1])


# ---------------------------------------------------------------------------
# prefill
@pytest.mark.parametrize("arch,S,window", [
    ("smollm-360m", 16, 0), ("gemma-7b", 16, 0), ("phi3-medium-14b", 16, 0),
    ("smollm-360m", 300, 0), ("smollm-360m", 300, 64)])
def test_forward_logits_match_reference(jref, arch, S, window):
    """S = 300 passes the reference's Q_CHUNK = 256 (its chunked path)."""
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref, arch)
    toks = np.random.RandomState(S).randint(0, cfg.vocab_size, (2, S))
    want, _ = jref.tr.forward_logits(jparams, {"tokens": jnp.asarray(toks)},
                                     jcfg, window=window)
    got, aux = tr.forward_logits(params, {"tokens": torch.from_numpy(toks)},
                                 cfg, window=window)
    assert got.shape == (2, S, cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want)


def test_prefill_step_is_the_last_position(jref):
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref, "smollm-360m")
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (3, 20))
    got = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(toks)})
    x, _ = jref.tr.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    want = jref.layers.lm_logits(jparams["embed"], x[:, -1:], jcfg)[:, 0]
    assert got.shape == (3, cfg.padded_vocab)
    _close(got, want)
    full, _ = tr.forward_logits(params, {"tokens": torch.from_numpy(toks)},
                                cfg)
    _close(got, full[:, -1].numpy())     # other matmul blocking: ~1e-6


# ---------------------------------------------------------------------------
# decode
@pytest.mark.parametrize("cache_len,window,steps", [
    (16, 0, 10),       # full cache
    (16, 8, 14),       # ring buffer of 8 slots, wrapped
    (8, 0, 12),        # full cache overflow: step >= L overwrites the last
])
def test_decode_steps_match_reference(jref, cache_len, window, steps):
    import jax
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref, "smollm-360m")
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
    for i, layer in enumerate(state["layers"]):
        for name in ("k", "v"):
            _close(layer[name], jstate["layers"][0][name][i])


LONG_STEPS = range(524_280, 524_296)      # long_500k's last positions


@pytest.mark.parametrize("arch", ["gemma-7b", "phi3-medium-14b"])
def test_window_decode_across_the_wrap_matches_reference(jref, arch,
                                                        record_property):
    """``make_decode_step(cfg, window=8)`` at absolute steps 524,280-
    524,295 (RoPE angles near 2^19 rad), through a ring of 8 slots filled
    with seeded K/V first: slot ``step % 8`` is written, the wrap at
    524,288 included, and every step's logits and the ring match the
    reference's (the long_500k decode of ``launch.steps.decode_window``
    at a smoke window).  The reference runs op by op
    (``jax.disable_jit``), the mode whose RoPE frequencies the port
    follows (ROADMAP Queue C, trap AJ).  Compiled, its frequencies round
    differently (test_rope_freqs_match_reference); the compiled
    reference's largest logit gap to the port over the 16 steps is
    reported (``compiled_reference_max_logit_gap``, printed), not held
    to a bound."""
    import jax
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref, arch)
    W = 8
    toks = np.random.RandomState(9).randint(0, cfg.vocab_size,
                                            (2, len(LONG_STEPS)))
    jstate = jref.tr.init_decode_state(jcfg, 2, 524_288, jnp.float32,
                                       window=W)
    state = tr.init_decode_state(cfg, 2, 524_288, torch.float32, window=W,
                                 device="cpu")
    rng = np.random.RandomState(10)
    unit = len(jstate["layers"])
    for i, layer in enumerate(state["layers"]):
        assert layer["k"].shape == (2, W, cfg.n_kv_heads, 64)
        for name in ("k", "v"):
            fill = rng.randn(*layer[name].shape).astype(np.float32)
            layer[name].copy_(torch.from_numpy(fill))
            j = jstate["layers"][i % unit]
            j[name] = j[name].at[i // unit].set(jnp.asarray(fill))
    jstep = functools.partial(jref.tr.decode_step, cfg=jcfg, window=W)
    compiled, cstate = jax.jit(jstep), jax.tree.map(lambda x: x, jstate)
    step = make_decode_step(cfg, W)
    gap = 0.0
    for n, t in enumerate(LONG_STEPS):
        before = [l["k"].clone() for l in state["layers"]]
        with jax.disable_jit():
            want, jstate = jstep(jparams, jstate,
                                 jnp.asarray(toks[:, n:n + 1]),
                                 jnp.asarray(t))
        got, state = step(params, state, torch.from_numpy(toks[:, n:n + 1]),
                          t)
        _close(got, want)
        cwant, cstate = compiled(jparams, cstate,
                                 jnp.asarray(toks[:, n:n + 1]),
                                 jnp.asarray(t))
        gap = max(gap, float(np.abs(got.numpy() - np.asarray(cwant)).max()))
        for b, l in zip(before, state["layers"]):
            moved = (b != l["k"]).any(dim=(0, 2, 3)).tolist()
            assert moved == [s == t % W for s in range(W)], (t, moved)
    for i, layer in enumerate(state["layers"]):
        for name in ("k", "v"):
            _close(layer[name], jstate["layers"][i % unit][name][i // unit])
    record_property("compiled_reference_max_logit_gap", gap)
    print(f"{arch}: the compiled reference's logits at steps "
          f"{LONG_STEPS[0]}-{LONG_STEPS[-1]}: max |gap| to the port {gap:.3e}")


def test_rope_freqs_match_reference(jref):
    """``rope_freqs`` against the reference's at head dims 64, 128 and 256
    and the configs' thetas, both f32 ``pow`` evaluated op by op: equal
    but for one frequency of 128 at head dim 256 and theta 10,000 (index
    111, 3.398e-4: 1.5e-5 rad of angle at position 524,280) and one each
    at theta 1e6, where torch's and jnp's ``pow`` round one ulp apart.
    The reference's compiled programs (XLA's ``pow`` under ``jax.jit``)
    round correctly and sit one ulp away from both on 10 to 43 of the
    frequencies (ROADMAP Queue C, trap AJ)."""
    import jax

    odd = {(256, 1e4): [111], (128, 1e6): [37], (256, 1e6): [74]}
    for hd in (64, 128, 256):
        for theta in (1e4, 5e5, 1e6):
            got = layers.rope_freqs(hd, theta).numpy()
            want = np.asarray(jref.layers.rope_freqs(hd, theta))
            assert got.dtype == np.float32 and got.shape == (hd // 2,)
            off = np.flatnonzero(got != want).tolist()
            assert off == odd.get((hd, theta), []), (hd, theta, off)
            compiled = np.asarray(jax.jit(
                lambda: jref.layers.rope_freqs(hd, theta))())
            for other in (want, compiled):
                assert np.abs(got.view(np.int32)
                              - other.view(np.int32)).max() <= 1


def test_decode_attention_cache_slots():
    """The slot written and the valid length, step by step."""
    cfg = reduce_for_smoke(get_arch("smollm-360m"))
    p = attn.init_attention(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    for window, L, step, slot in [(0, 4, 2, 2), (0, 4, 6, 3), (4, 4, 6, 2)]:
        cache = {n: torch.zeros(2, L, cfg.n_kv_heads, 64) for n in "kv"}
        _, cache = attn.decode_attention(p, x, cache, step, cfg,
                                         window=window)
        written = [int(cache["k"][0, s].abs().sum() > 0) for s in range(L)]
        assert written == [int(s == slot) for s in range(L)]
    stacked = attn.init_kv_cache(cfg, 2, 8, 3, torch.bfloat16)
    assert stacked["v"].shape == (3, 2, 8, cfg.n_kv_heads, 64)
    assert stacked["k"].dtype == torch.bfloat16 and not stacked["k"].any()


# ---------------------------------------------------------------------------
# serving
@pytest.mark.parametrize("arch,window,new", [
    ("smollm-360m", 0, (6, 10)),
    ("smollm-360m", 8, (9, 10)),
    ("gemma-7b", 8, (9, 10)),
    ("hymba-1.5b", 8, (9, 10))])
def test_serve_engine_greedy_tokens_equal_reference(jref, arch, window, new):
    """Two greedy requests; the second's prompt + max_new (12 + 10) runs
    past cache_len = 16.  With ``window`` 8 both engines decode through
    a ring of 8 slots, which every request's run wraps."""
    jparams, params, jcfg, cfg = _both(jref, arch)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12)]
    jeng = jref.serving.ServeEngine(jparams, jcfg, batch=2, cache_len=16,
                                    window=window)
    want = jeng.generate([jref.serving.ServeRequest(prompt=p, max_new=m)
                          for p, m in zip(prompts, new)])
    fa_k.reset_launch_counts()
    dec_k.reset_launch_counts()
    eng = ServeEngine(params, cfg, batch=2, cache_len=16, window=window,
                      device="cpu")
    got = eng.generate([ServeRequest(prompt=p, max_new=m)
                        for p, m in zip(prompts, new)])
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert [len(g) for g in got] == list(new)
    assert eng.steps == 12 + 10
    assert fa_k.LAUNCHES["flash_attention"] == 0
    assert dec_k.LAUNCHES["decode_attention"] == 0


def test_serve_engine_sampling_is_seeded_and_in_range(jref):
    _, params, _, cfg = _both(jref, "smollm-360m")
    prompts = [np.arange(3, 9, dtype=np.int32), np.arange(1, 4,
                                                          dtype=np.int32)]

    def run(seed):
        eng = ServeEngine(params, cfg, batch=3, cache_len=32, seed=seed,
                          device="cpu")
        return eng.generate([ServeRequest(prompt=p, max_new=8,
                                          temperature=1.0)
                             for p in prompts])

    a, b, c = run(0), run(0), run(1)
    for out in a + c:
        assert out.dtype == np.int32 and len(out) == 8
        assert ((out >= 0) & (out < cfg.vocab_size)).all()
    assert [x.tolist() for x in a] == [x.tolist() for x in b]
    assert [x.tolist() for x in a] != [x.tolist() for x in c]


def test_serve_engine_rejects_params_on_another_device(jref):
    _, params, _, cfg = _both(jref, "smollm-360m")
    with pytest.raises(ValueError, match="prompts"):
        ServeEngine(params, cfg, batch=1, cache_len=8,
                    device="cpu").prefill([np.ones(3), np.ones(3)])
    with pytest.raises(ValueError, match="engine on meta"):
        ServeEngine(params, cfg, batch=1, cache_len=8, device="meta")


def test_serve_cli_runs_the_smoke_model_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-360m", "--smoke", "--device", "cpu", "--requests", "2",
         "--max-new", "4"], cwd=REPO_ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}, check=True)
    assert "req 1: " in out.stdout and "8 tokens" in out.stdout


# ---------------------------------------------------------------------------
# what is not ported yet
def test_training_and_cross_attention_raise_not_yet_ported():
    """LM training's input noise is ported now (``noise=(gen, sigma)``
    moves the hidden states), and cross-attention is (see
    test_torch_encdec.py); the MoE's group sharding builds and runs
    under no mesh, and over a 'model' mesh axis of two devices (a fake
    process group) one program's forward is the same bits (its split over
    "model" runs in a rank's step: test_torch_tensor_parallel_moe_xlstm.
    py).  B4's bf16 backward is ported: on the card a bf16 B4
    call under autograd is the Function and carries a gradient (that
    half needs a card)."""
    import dataclasses

    from test_torch_reference import fake_mesh

    from repro_torch.distributed.context import clear_mesh, set_mesh

    cfg = reduce_for_smoke(get_arch("smollm-360m"))
    params = tr.init_lm(torch.Generator(), cfg, device="cpu")
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    clean, _ = tr.forward(params, toks, cfg)
    noisy, _ = tr.forward(params, toks, cfg,
                          noise=(torch.Generator().manual_seed(0), 1.0))
    assert noisy.shape == clean.shape and not torch.equal(noisy, clean)
    moe = dataclasses.replace(reduce_for_smoke(get_arch("olmoe-1b-7b")),
                              moe_impl="einsum", moe_group_shard=True)
    moe_params = tr.init_lm(torch.Generator(), moe, device="cpu")
    plain, _ = tr.forward(moe_params, toks, moe)
    with fake_mesh((1, 2), ("data", "model")) as mesh:
        set_mesh(mesh)
        try:
            placed, _ = tr.forward(moe_params, toks, moe)
        finally:
            clear_mesh()
    assert torch.equal(placed, plain)
    if torch.cuda.is_available():
        q = torch.randn((1, 8, 2, 64), device="cuda",
                        dtype=torch.bfloat16).requires_grad_(True)
        k = torch.randn((1, 8, 1, 64), device="cuda", dtype=torch.bfloat16)
        out = fa_k.flash_attention(q, k, k)
        assert "FlashAttentionFn" in type(out.grad_fn).__name__
        (dq,) = torch.autograd.grad(out.float().sum(), (q,))
        assert dq.dtype == torch.bfloat16 and bool(torch.isfinite(dq).all())
