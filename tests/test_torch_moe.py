"""The MoE FFN of the port (``repro_torch.models.moe``) and the two MoE
models it serves, Granite-MoE-3B-a800m and OLMoE-1B-7B, against the JAX
reference on the CPU, at their smoke size (``reduce_for_smoke``: 2
layers, d 256, 4 experts, top-2, d_ff 512, f32).  Both packages get the
same numpy inputs and the reference's own ``init_moe``/``init_lm``
weights.

What is held:

* the routing, exactly: the top-k experts of every token and the keep
  mask (which (token, slot) pairs capacity drops).  The reference returns
  neither, so :func:`_ref_routing` runs the first lines of the
  reference's ``moe_ffn`` in jax (router einsum, softmax, ``lax.top_k``,
  the one-hot exclusive cumsum; the einsum form counts alike within each
  group, in f32, which is exact for these counts).  No case here meets a
  near-tie of the k-th and (k+1)-th probability (``torch.topk`` and
  ``lax.top_k`` may order exact ties differently);
* y within abs/rel 1e-5 (f32 sums over d = 256 and d_ff = 512 in other
  orders, ~1e-6 measured) and the aux loss within rel 1e-5;
* whole-model logits within abs/rel 2e-5, as ``test_torch_lm.py``
  holds the dense models, the aux loss within rel 1e-5; decode steps;
  ``ServeEngine`` greedy tokens equal.

Also the reference's own MoE properties (``tests/test_variants_and_
perf.py``) and serving test (``tests/test_serving_and_steps.py::
test_batched_requests``) run on the port, the weight carry-over, the CLI,
and what the port refuses.  The reference's ``repro.models.moe``,
``transformer`` and ``serving`` import without the ``jax.core`` alias.
"""
import contextlib
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
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.serving import ServeEngine, ServeRequest

ARCHS = ["granite-moe-3b-a800m", "olmoe-1b-7b"]
FACTORS = [1.25, 0.5, 4.0]
Y_TOL = 1e-5
AUX_RTOL = 1e-5
LOGIT_TOL = 2e-5
REPO_ROOT = __file__.rsplit("/tests/", 1)[0]


@pytest.fixture(scope="module")
def jref():
    names = {"configs": "repro.configs", "moe": "repro.models.moe",
             "tr": "repro.models.transformer", "serving": "repro.serving"}
    return SimpleNamespace(**{k: importlib.import_module(v)
                              for k, v in names.items()})


def _with_factor(cfg, factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _cfgs(jref, arch, factor=None):
    """(reference cfg, port cfg) of the smoke variant of ``arch``, at
    ``factor`` (the config's own capacity factor when None)."""
    jcfg = jref.configs.reduce_for_smoke(jref.configs.get_arch(arch))
    cfg = reduce_for_smoke(get_arch(arch))
    if factor is not None:
        jcfg, cfg = _with_factor(jcfg, factor), _with_factor(cfg, factor)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _moe_weights(arch):
    """The reference's ``init_moe`` of the smoke config, as numpy."""
    import jax

    jconfigs = importlib.import_module("repro.configs")
    jmoe = importlib.import_module("repro.models.moe")
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_arch(arch))
    return {k: np.asarray(v)
            for k, v in jmoe.init_moe(jax.random.PRNGKey(0), jcfg).items()}


@functools.lru_cache(maxsize=None)
def _lm_weights(arch):
    """The reference's ``init_lm`` of the smoke config, as numpy."""
    import jax

    jconfigs = importlib.import_module("repro.configs")
    jtr = importlib.import_module("repro.models.transformer")
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_arch(arch))
    return jax.tree.map(np.asarray, jtr.init_lm(jax.random.PRNGKey(0), jcfg))


def _both_moe(arch):
    import jax.numpy as jnp

    w = _moe_weights(arch)
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v.copy()) for k, v in w.items()})


def _both_lm(jref, arch):
    """(jax params, port params, reference cfg, port cfg)."""
    import jax
    import jax.numpy as jnp

    tree = _lm_weights(arch)
    jcfg, cfg = _cfgs(jref, arch)
    return (jax.tree.map(jnp.asarray, tree),
            tr.lm_params_from_numpy(tree, cfg, device="cpu"), jcfg, cfg)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _ref_routing(jparams, x, jcfg, cap, group):
    """(idx, keep) of the reference's routing of ``x`` (..., d): its
    ``moe_ffn``'s lines up to ``keep``, counting positions within each
    run of ``group`` tokens."""
    import jax
    import jax.numpy as jnp

    E, k = jcfg.moe.n_experts, jcfg.moe.top_k
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    N = xf.shape[0]
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        jparams["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    e_flat = idx.reshape(N // group, group * k)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    pos_in_e = jnp.take_along_axis(pos, e_flat[..., None], axis=2)[..., 0]
    return np.asarray(idx), np.asarray(pos_in_e.reshape(N, k) < cap)


# ---------------------------------------------------------------------------
# init and capacity
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_shapes_and_dtypes_match_reference(jref, arch, param_dtype):
    import jax

    jcfg, cfg = _cfgs(jref, arch)
    jcfg = dataclasses.replace(jcfg, param_dtype=param_dtype)
    cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    want = jref.moe.init_moe(jax.random.PRNGKey(0), jcfg)
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    again = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
        assert torch.equal(got[name], again[name]), name
    assert got["router"].dtype == torch.float32
    # fan-in scaling on the d (or f) axis, truncated at two deviations
    std = float(got["w_down"].float().std())
    assert abs(std * np.sqrt(cfg.d_ff) - 0.88) < 0.05


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(jref, arch, factor):
    jcfg, cfg = _cfgs(jref, arch, factor)
    full = (get_arch(arch), jref.configs.get_arch(arch))
    for n in [1, 2, 7, 8, 9, 16, 32, 37, 111, 512, 600, 4096, 16384]:
        assert moe.capacity(n, cfg) == jref.moe.capacity(n, jcfg), n
        c, jc = (_with_factor(c, factor) for c in full)
        assert moe.capacity(n, c) == jref.moe.capacity(n, jc), n
    assert moe.capacity(4 * 4096, get_arch("granite-moe-3b-a800m")) == 4096
    assert moe.capacity(4 * 4096, get_arch("olmoe-1b-7b")) == 2560


# ---------------------------------------------------------------------------
# the FFN
@pytest.mark.parametrize("B,S", [(2, 16), (3, 37)])
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("impl", ["scatter", "einsum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(jref, arch, impl, factor, B, S):
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(jref, arch, factor)
    jparams, params = _both_moe(arch)
    x = np.random.RandomState(B * S).randn(B, S, cfg.d_model).astype(
        np.float32)
    T = B * S
    if impl == "scatter":
        jfn, fn = jref.moe.moe_ffn, moe.moe_ffn
        cap, group = moe.capacity(T, cfg), T
    else:
        jfn, fn = jref.moe.moe_ffn_einsum, moe.moe_ffn_einsum
        _, group, cap = moe.einsum_groups(T, cfg)
    idx, keep = _ref_routing(jparams, x, jcfg, cap, group)
    r = moe.route(params, torch.from_numpy(x.reshape(T, -1)), cfg, cap,
                  group)
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if factor == 0.5:
        assert not keep.all()        # capacity really drops here
    want_y, want_aux = jfn(jparams, jnp.asarray(x), jcfg)
    y, aux = fn(params, torch.from_numpy(x), cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert aux.shape == () and aux.dtype == torch.float32
    _close(y, want_y, Y_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL)
    # a token whose every slot was dropped gets no update in either
    dropped = ~keep.all(axis=1)
    if dropped.any() and not keep[dropped].any():
        assert not y.reshape(T, -1)[torch.from_numpy(dropped)].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_einsum_form_refuses_what_the_reference_refuses(jref, arch):
    """(2, 300): T = 600 is not a multiple of ``GROUP_SIZE`` 512.  The
    scatter form takes it and matches the reference."""
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(jref, arch)
    jparams, params = _both_moe(arch)
    x = np.random.RandomState(600).randn(2, 300, cfg.d_model).astype(
        np.float32)
    with pytest.raises(AssertionError):
        jref.moe.moe_ffn_einsum(jparams, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="not a multiple of the group size"):
        moe.moe_ffn_einsum(params, torch.from_numpy(x), cfg)
    want, _ = jref.moe.moe_ffn(jparams, jnp.asarray(x), jcfg)
    got, _ = moe.moe_ffn(params, torch.from_numpy(x), cfg)
    _close(got, want, Y_TOL)


def _jax_normal(seed, shape):
    import jax
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


def test_einsum_moe_matches_scatter(monkeypatch):
    """The reference's ``test_einsum_moe_matches_scatter`` on the port:
    four groups of 32 tokens, no drops, the two forms within 1e-4."""
    monkeypatch.setattr(moe, "GROUP_SIZE", 32)
    cfg = _with_factor(reduce_for_smoke(get_arch("granite-moe-3b-a800m")),
                       4.0)
    params = {k: torch.from_numpy(v.copy())
              for k, v in _moe_weights("granite-moe-3b-a800m").items()}
    x = torch.from_numpy(_jax_normal(1, (2, 64, cfg.d_model)) * 0.5)
    y1, _ = moe.moe_ffn(params, x, cfg)
    y2, _ = moe.moe_ffn_einsum(params, x, cfg)
    torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-4)


def test_einsum_moe_capacity_drop_consistent(monkeypatch):
    """The reference's ``test_einsum_moe_capacity_drop_consistent`` on the
    port: one group of 128 tokens, the same cumsum order, so the same
    drops (which happen here) give the same update."""
    monkeypatch.setattr(moe, "GROUP_SIZE", 128)
    cfg = _with_factor(reduce_for_smoke(get_arch("olmoe-1b-7b")), 0.5)
    params = {k: torch.from_numpy(v.copy())
              for k, v in _moe_weights("olmoe-1b-7b").items()}
    x = torch.from_numpy(_jax_normal(2, (1, 128, cfg.d_model)))
    y1, _ = moe.moe_ffn(params, x, cfg)
    y2, _ = moe.moe_ffn_einsum(params, x, cfg)
    assert not moe.route(params, x[0], cfg, moe.capacity(128, cfg),
                         128).keep.all()
    torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forms_hold_the_f32_result(arch):
    """Both forms in bf16 against the f32 scatter form on the same inputs,
    at capacity factor 4 (no drops), within ``chip_smoke.moe_forms``'s
    bounds: RMS error <= 2^-5 and max error <= 2^-2 of the output's RMS.
    The two bf16 forms round at other places, so where the gated terms
    cancel they differ by more than one rounding of the output."""
    cfg = dataclasses.replace(
        _with_factor(reduce_for_smoke(get_arch(arch)), 4.0),
        compute_dtype="bfloat16")
    params = {k: torch.from_numpy(v.copy())
              for k, v in _moe_weights(arch).items()}
    x = torch.from_numpy(np.random.RandomState(9).randn(
        2, 256, cfg.d_model).astype(np.float32)).bfloat16()
    y32, _ = moe.moe_ffn(params, x.float(), cfg)
    rms = float(y32.pow(2).mean().sqrt())
    for fn in (moe.moe_ffn, moe.moe_ffn_einsum):
        y, _ = fn(params, x, cfg)
        assert y.dtype == torch.bfloat16
        err = y.float() - y32
        assert float(err.pow(2).mean().sqrt()) <= 2.0 ** -5 * rms
        assert float(err.abs().max()) <= 2.0 ** -2 * rms


def test_moe_spans_label_the_ffn_only_under_the_profiler():
    """``profile_serve.span_times`` finds each of ``moe.SPANS`` once per
    layer under ``torch.profiler``; outside it nothing is labelled."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.profile_serve import span_times

    cfg = reduce_for_smoke(get_arch("granite-moe-3b-a800m"))
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = {"tokens": torch.zeros((2, 8), dtype=torch.int64)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.forward_logits(params, toks, cfg)
    spans = span_times(prof.events())
    assert sorted(spans) == sorted(moe.SPANS)
    assert all(host > 0 for _, host in spans.values())
    assert {n: sum(e.name == n for e in prof.events())
            for n in moe.SPANS} == {n: cfg.n_layers for n in moe.SPANS}
    assert isinstance(moe._span("moe.route"), contextlib.nullcontext)


@pytest.mark.parametrize("N,k,E,group", [(111, 2, 4, 111), (64, 8, 40, 16),
                                         (512, 8, 64, 128), (1, 2, 4, 1)])
def test_positions_equal_the_one_hot_cumsum(N, k, E, group):
    """``moe.positions`` (a stable sort by (group, expert)) against the
    reference's formulation, the exclusive cumsum of the one-hot experts
    over each group's (token, slot) pairs, on random routings."""
    gen = torch.Generator().manual_seed(N + E)
    idx = torch.stack([torch.randperm(E, generator=gen)[:k]
                       for _ in range(N)])
    onehot = torch.nn.functional.one_hot(idx.reshape(N // group, group * k),
                                         E)
    ahead = torch.cumsum(onehot, dim=1) - onehot
    want = ahead.gather(2, idx.reshape(N // group, group * k, 1))
    assert torch.equal(moe.positions(idx, E, group), want.reshape(N, k))


def test_route_positions_follow_token_order():
    """Positions count (token, slot) pairs token-major, slot-minor, across
    the whole call: with a router that sends every token to experts 0
    then 1, token t takes position t in both, and capacity keeps the
    first ``cap`` tokens."""
    cfg = reduce_for_smoke(get_arch("olmoe-1b-7b"))
    d = cfg.d_model
    router = torch.zeros(d, 4)
    router[0] = torch.tensor([3.0, 2.0, 0.0, -1.0])
    params = {"router": router}
    xf = torch.ones(12, d)
    r = moe.route(params, xf, cfg, cap=8, group=12)
    assert r.idx.tolist() == [[0, 1]] * 12
    assert r.pos.tolist() == [[t, t] for t in range(12)]
    assert r.keep.tolist() == [[t < 8, t < 8] for t in range(12)]
    grouped = moe.route(params, xf, cfg, cap=8, group=4)
    assert grouped.pos.tolist() == [[t % 4, t % 4] for t in range(12)]
    torch.testing.assert_close(r.weights.sum(-1), torch.ones(12))


def test_route_replay_takes_the_recorded_routing():
    """``chip_smoke.RouteReplay``, which holds a bf16 tensor-parallel run
    to world 1 on the rank's routing: a bf16 prefill replaying its own
    recorded routing gives its logits bit for bit; another token's
    experts change the logits (at capacity factor 4: nothing drops, so
    every slot stays kept); and a kept slot that the replayed experts'
    positions contradict raises."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(
        _with_factor(reduce_for_smoke(get_arch(ARCHS[0])), 4.0),
        compute_dtype="bfloat16")
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    step = make_prefill_step(cfg)
    with smoke.RouteLog() as log_:
        want = step(params, {"tokens": tokens})
    routes = smoke.tp_routes(log_)
    with smoke.RouteReplay(routes) as replay:
        got = step(params, {"tokens": tokens})
    assert replay.used == len(routes) == cfg.n_layers
    assert torch.equal(got, want)
    idx, keep, gap = routes[0]
    moved = idx.clone()
    moved[0] = (moved[0] + 1) % cfg.moe.n_experts   # still k distinct
    with smoke.RouteReplay([(moved, keep, gap)] + routes[1:]):
        assert not torch.equal(step(params, {"tokens": tokens}), want)
    with pytest.raises(AssertionError, match="kept slots"):
        with smoke.RouteReplay([(idx, ~keep, gap)] + routes[1:]):
            step(params, {"tokens": tokens})


# ---------------------------------------------------------------------------
# the model
@pytest.mark.parametrize("S", [16, 300])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(jref, arch, S):
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both_lm(jref, arch)
    toks = np.random.RandomState(S).randint(0, cfg.vocab_size, (2, S))
    want, want_aux = jref.tr.forward_logits(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tr.forward_logits(params, {"tokens": torch.from_numpy(toks)},
                                 cfg)
    assert got.shape == (2, S, cfg.padded_vocab)
    _close(got, want, LOGIT_TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(jref, arch):
    import jax
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both_lm(jref, arch)
    steps = 10
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (3, steps))
    jstate = jref.tr.init_decode_state(jcfg, 3, 16, jnp.float32)
    state = tr.init_decode_state(cfg, 3, 16, torch.float32, device="cpu")
    jstep = jax.jit(functools.partial(jref.tr.decode_step, cfg=jcfg))
    step = make_decode_step(cfg)
    for t in range(steps):
        want, jstate = jstep(jparams, jstate, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(t))
        got, state = step(params, state, torch.from_numpy(toks[:, t:t + 1]),
                          t)
        assert got.shape == (3, 1, cfg.padded_vocab)
        _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode_when_nothing_drops(jref, arch, monkeypatch):
    """Capacity is per call (T = B S in prefill, T = B in decode), so the
    two agree only where the prefill dropped nothing: asserted first, at
    capacity factor 4 (at the config's 1.25 this prompt drops)."""
    _, params, _, cfg = _both_lm(jref, arch)
    cfg = _with_factor(cfg, 4.0)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 12)))
    kept = []
    real_route = moe.route

    def spy(*args, **kwargs):
        r = real_route(*args, **kwargs)
        kept.append(bool(r.keep.all()))
        return r

    monkeypatch.setattr(moe, "route", spy)
    full, _ = tr.forward_logits(params, {"tokens": toks}, cfg)
    monkeypatch.undo()
    assert kept == [True, True]
    state = tr.init_decode_state(cfg, 2, 12, torch.float32, device="cpu")
    step = make_decode_step(cfg)
    for t in range(12):
        got, state = step(params, state, toks[:, t:t + 1], t)
        torch.testing.assert_close(got[:, 0], full[:, t], atol=2e-5,
                                   rtol=2e-5)
    last = make_prefill_step(cfg)(params, {"tokens": toks})
    torch.testing.assert_close(last, full[:, -1], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_greedy_tokens_equal_reference(jref, arch):
    jparams, params, jcfg, cfg = _both_lm(jref, arch)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12)]
    new = (6, 10)
    jeng = jref.serving.ServeEngine(jparams, jcfg, batch=2, cache_len=32)
    want = jeng.generate([jref.serving.ServeRequest(prompt=p, max_new=m)
                          for p, m in zip(prompts, new)])
    eng = ServeEngine(params, cfg, batch=2, cache_len=32, device="cpu")
    got = eng.generate([ServeRequest(prompt=p, max_new=m)
                        for p, m in zip(prompts, new)])
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert eng.steps == 12 + 10


def test_batched_requests():
    """The reference's ``test_batched_requests`` on the port (its own
    random weights): OLMoE's smoke model, three requests of other lengths,
    one sampled."""
    cfg = reduce_for_smoke(get_arch("olmoe-1b-7b"))
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServeEngine(params, cfg, batch=3, cache_len=32, device="cpu")
    reqs = [ServeRequest(prompt=np.array([1, 2], np.int32), max_new=4),
            ServeRequest(prompt=np.array([9], np.int32), max_new=3),
            ServeRequest(prompt=np.array([4, 4, 4], np.int32), max_new=4,
                         temperature=0.7)]
    outs = eng.generate(reqs)
    assert [len(o) for o in outs] == [4, 3, 4]
    assert all((o >= 0).all() and (o < cfg.vocab_size).all() for o in outs)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip(jref, arch):
    import jax

    tree = _lm_weights(arch)
    _, cfg = _cfgs(jref, arch)
    params = tr.lm_params_from_numpy(tree, cfg, device="cpu")
    back = tr.lm_params_to_numpy(params, cfg)
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_b, flat_t):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            params["layers"][1]["moe"][name].numpy(),
            tree["unit"][0]["moe"][name][1])
    mine = tr.lm_params_to_numpy(
        tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(mine)[0], flat_t):
        assert a.shape == b.shape and a.dtype == b.dtype, path


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_moe_smoke_model_on_the_cpu(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "2", "--max-new", "4"],
        cwd=REPO_ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}, check=True)
    assert "req 1: " in out.stdout and "8 tokens" in out.stdout


# ---------------------------------------------------------------------------
# what the port refuses
@pytest.mark.parametrize("impl", ["scatter", "einsum"])
def test_moe_group_shard_raises_not_yet_ported(impl):
    """``moe_group_shard`` under no mesh: the model and its decode state
    build, and the layer's output is bit for bit the one without it.
    Over a 'model' mesh axis of two devices (a fake process group) it is
    still the identity in one program, in both forms (the einsum form
    splits its groups over "model" only in a rank's step, under
    ``ranks=``: ``tests/test_torch_tensor_parallel_moe_xlstm.py``); the
    scatter form does not read the knob, as in the reference."""
    from test_torch_reference import fake_mesh

    from repro_torch.distributed.context import clear_mesh, set_mesh

    cfg = dataclasses.replace(reduce_for_smoke(get_arch("olmoe-1b-7b")),
                              moe_impl=impl, moe_group_shard=True)
    tr.init_lm(torch.Generator(), cfg, device="cpu")
    tr.init_decode_state(cfg, 1, 8, torch.float32, device="cpu")
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    plain = dataclasses.replace(cfg, moe_group_shard=False)
    ffn = tr.MOE_IMPLS[impl]
    assert torch.equal(ffn(params, x, cfg)[0], ffn(params, x, plain)[0])
    with fake_mesh((1, 2), ("data", "model")) as mesh:
        set_mesh(mesh)
        try:
            assert torch.equal(moe.moe_ffn_einsum(params, x, cfg)[0],
                               moe.moe_ffn_einsum(params, x, plain)[0])
            assert torch.equal(moe.moe_ffn(params, x, cfg)[0],
                               moe.moe_ffn(params, x, plain)[0])
        finally:
            clear_mesh()


def test_unknown_moe_impl_raises():
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("olmoe-1b-7b")),
                              moe_impl="dense")
    with pytest.raises(ValueError, match="moe_impl 'dense'"):
        tr.init_lm(torch.Generator(), cfg, device="cpu")
