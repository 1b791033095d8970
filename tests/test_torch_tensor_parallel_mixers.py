"""Tensor-parallel serving of the hybrid and the encoder-decoder families
over a ("data", "model") mesh on the CPU: ``launch.steps.prefill_setup``
and ``ServeEngine(..., ranks=)`` as every rank of a 1 x 2 gloo mesh (both
cases in one spawn) and of a 2 x 2 one (Hymba alone: the Mamba state's
rows split over "data" too), each rank holding its blocks of the
reference's smoke weights (``tp_ranks.tp_job``).

Cases (``reduce_for_smoke`` configs, d 256, head_dim 64, f32): Hymba
(2 layers, 4/2 heads: B4 on a rank's heads; the Mamba heads on a rank's
128 of their 256 channels, B6 once a chunk on them) and SeamlessM4T (2
encoder and 2 decoder layers, 4/2 heads: B4 without the mask on a rank's
heads in the encoder and in the cross-attention prefill, B5 whole over
the 16-frame memory on a rank's heads in a decode step).  The engine's
cache of 64 positions splits over "model" by positions; its 36 steps
(the prompts token by token, then 6 greedy tokens) reach rank 1's
block from step 32 on, and each rank above 0 is checked to have been
handed a non-empty block.  SeamlessM4T's engine decodes against each
rank's own ``encode`` of the frames.

Each rank's prefill logits (its rows, its vocabulary block) and the
engine's logits at every step are held to the port at world 1 within
2e-5 absolute (f32 sums regrouped over the ranks) and to the reference's
``forward``/``decode_step`` on one device (teacher-forced with world 1's
tokens) within the bound its own Hymba and SeamlessM4T tests use, 2e-5
absolute and relative (B6 folds in time order, the reference's scan in a
tree order); the greedy tokens equal world 1's and the reference's, a
flip allowed only where world 1's top two logits are within 1e-5
(counted: none occur).  Each rank holds only its blocks of the weights
and of the decode state (Mamba's ``h`` and ``conv`` on its channels);
its exchanges at every step equal the ones the same step counts first on
``meta`` structs of its blocks.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest
from dp_ranks import run_ranks
from test_torch_reference import one_thread
from test_torch_tensor_parallel import (LOGIT_TOL, _hold_tokens,
                                        _vocab_block)
from tp_ranks import case_cfg, mixer_inputs, run_case

REF_TOL = dict(atol=2e-5, rtol=2e-5)     # the reference tests' model bound
CACHE = 64                 # 32 positions a "model" rank
PROMPTS = (11, 30)         # with 6 new tokens: 36 steps
MAX_NEW = 6
CASES = {"hymba": dict(arch="hymba-1.5b"),
         "seamless": dict(arch="seamless-m4t-medium")}
MESHES = {"1x2": ((1, 2), ("hymba", "seamless")), "2x2": ((2, 2),
                                                          ("hymba",))}
ON_MESH = [(m, c) for m, (_, names) in MESHES.items() for c in names]
MIXER_SEED = 21


@functools.lru_cache(maxsize=None)
def _ref_cfg(name):
    jconfigs = importlib.import_module("repro.configs")
    return jconfigs.reduce_for_smoke(jconfigs.get_arch(CASES[name]["arch"]))


def _case(name):
    """The case's inputs, with the reference's ``init_lm`` weights."""
    import jax

    jtr = importlib.import_module("repro.models.transformer")
    case = dict(CASES[name])
    jcfg = _ref_cfg(name)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(case_cfg(case))
    case["weights"] = jax.tree.map(
        np.asarray, jtr.init_lm(jax.random.PRNGKey(9), jcfg))
    rng = np.random.RandomState(len(name) + 100)
    V = jcfg.vocab_size
    case["tokens"] = rng.randint(0, V, (2, 140))   # Hymba: 2 chunks of 128
    if jcfg.n_enc_layers:
        case["enc"] = rng.randn(2, jcfg.frontend_tokens,
                                jcfg.d_model).astype(np.float32)
        case["tokens"] = case["tokens"][:, :12]
    case["prompts"] = [rng.randint(0, V, n).astype(np.int32)
                       for n in PROMPTS]
    case["max_new"], case["cache_len"] = MAX_NEW, CACHE
    return case


def _reference(name, case, world1):
    """The reference on one device: the prefill's logits, each engine
    step's logits fed world 1's tokens (the left-padded prompts, then the
    greedy tokens it drew), its own engine's greedy tokens; the memory
    its ``encode`` of the frames."""
    import jax
    import jax.numpy as jnp

    jtr = importlib.import_module("repro.models.transformer")
    jlayers = importlib.import_module("repro.models.layers")
    jserving = importlib.import_module("repro.serving")
    jcfg = _ref_cfg(name)
    jp = jax.tree.map(jnp.asarray, case["weights"])
    inputs = {"tokens": jnp.asarray(case["tokens"])}
    if "enc" in case:
        inputs["enc_embeds"] = jnp.asarray(case["enc"])
    x, _ = jtr.forward(jp, inputs, jcfg)
    prefill = np.asarray(jlayers.lm_logits(jp["embed"], x[:, -1:],
                                           jcfg)[:, 0])
    prompts = case["prompts"]
    n = max(len(p) for p in prompts)
    fed = np.zeros((len(prompts), n), np.int32)
    for i, p in enumerate(prompts):
        fed[i, n - len(p):] = p
    fed = np.concatenate([fed, np.stack(world1["tokens"])], axis=1)
    step = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
    state = jtr.init_decode_state(jcfg, len(prompts), CACHE, jnp.float32)
    memory = (jtr.encode(jp, jnp.asarray(case["enc"]), jcfg)
              if "enc" in case else None)
    if memory is not None:
        state["memory"] = memory
    logits = []
    for t in range(fed.shape[1]):
        got, state = step(jp, state, jnp.asarray(fed[:, t:t + 1]),
                          jnp.asarray(t))
        logits.append(np.asarray(got[:, -1]))
    eng = jserving.ServeEngine(jp, jcfg, batch=len(prompts), cache_len=CACHE)
    if memory is not None:
        eng.state["memory"] = memory
    toks = eng.generate([jserving.ServeRequest(prompt=p, max_new=MAX_NEW)
                         for p in prompts])
    return dict(prefill=prefill, step_logits=logits,
                tokens=[np.asarray(t) for t in toks])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both cases at world 1 and on the reference, and every mesh's ranks
    (one spawn a mesh)."""
    cases = {name: _case(name) for name in CASES}
    with one_thread():
        world1 = {name: run_case(c) for name, c in cases.items()}
    ref_runs = {name: _reference(name, c, world1[name])
                for name, c in cases.items()}
    tmp = tmp_path_factory.mktemp("tp_mixers")
    ranks = {mesh: run_ranks(shape, "tp_ranks:tp_job", dict(
        cases={n: cases[n] for n in names}, mixer=MIXER_SEED), tmp)
        for mesh, (shape, names) in MESHES.items()}
    return dict(cases=cases, world1=world1, ref=ref_runs, ranks=ranks)


def _close_to_both(got, w1, jr, err_msg=""):
    np.testing.assert_allclose(got, w1, atol=LOGIT_TOL, rtol=0,
                               err_msg=err_msg)
    np.testing.assert_allclose(got, jr, **REF_TOL, err_msg=err_msg)


@pytest.mark.parametrize("mesh,name", ON_MESH)
def test_ranks_match_world_one_and_the_reference(runs, mesh, name):
    w1, jr = runs["world1"][name], runs["ref"][name]
    (R, M), _ = MESHES[mesh]
    np.testing.assert_allclose(w1["prefill"], jr["prefill"], **REF_TOL)
    for r, out in enumerate(runs["ranks"][mesh]):
        got = out[name]
        m = r % M
        assert got["structs_match"]
        r0, r1 = got["rows"]
        assert r1 - r0 == 2 // R
        assert np.array_equal(got["embed"], w1["embed"][r0:r1])
        _close_to_both(got["prefill"],
                       _vocab_block(w1["prefill"][r0:r1], m, M),
                       _vocab_block(jr["prefill"][r0:r1], m, M),
                       f"prefill rank {r}")
        e0, e1 = got["engine_rows"]
        first, flips = _hold_tokens(got["tokens"], w1["tokens"],
                                    w1["step_logits"], (0, 0))
        _, ref_flips = _hold_tokens(got["tokens"], jr["tokens"],
                                    w1["step_logits"], (0, 0))
        assert flips == ref_flips == 0
        assert len(got["step_logits"]) == max(PROMPTS) + MAX_NEW
        for t, lg in enumerate(got["step_logits"]):
            _close_to_both(lg, _vocab_block(w1["step_logits"][t][e0:e1],
                                            m, M),
                           _vocab_block(jr["step_logits"][t][e0:e1], m, M),
                           f"step {t} rank {r}")
        # every rank's block of the cache held positions at some step
        assert 0 < got["partial_len"] <= CACHE // M


@pytest.mark.parametrize("mesh,name", ON_MESH)
def test_launches_and_rank_blocks(runs, mesh, name):
    """B4 in every attention layer of the prefill (SeamlessM4T: encoder,
    self and cross), B6 once a chunk in each Hymba layer and never in a
    decode step, one B5 partial a self-attention layer and step and, for
    SeamlessM4T, one B5 whole a cross-attention layer and step; each
    rank holds its blocks of the weights and of the decode state, Mamba's
    included, at world 1's shapes split as the plan says."""
    cfg = case_cfg(CASES[name])
    w1 = runs["world1"][name]
    (R, M), _ = MESHES[mesh]
    L, n_steps = cfg.n_layers, max(PROMPTS) + MAX_NEW
    mamba = name == "hymba"
    chunks = -(-runs["cases"][name]["tokens"].shape[1] // 128)
    cross = 0 if mamba else L            # cross-attention layers
    pre = dict(flash_attention=cfg.n_enc_layers + L + cross,
               decode_attention=0, decode_attention_partial=0)
    eng = dict(flash_attention=0, decode_attention=cross * n_steps,
               decode_attention_partial=L * n_steps)
    one = dict(eng, decode_attention=(L + cross) * n_steps,
               decode_attention_partial=0)     # world 1: B5 whole
    if mamba:
        pre["ssm_scan"] = L * chunks
        eng["ssm_scan"] = one["ssm_scan"] = 0
    assert w1["prefill_calls"] == pre
    assert w1["engine_calls"] == one
    for out in runs["ranks"][mesh]:
        got = out[name]
        assert got["prefill_calls"] == pre
        assert got["engine_calls"] == eng
        layer, whole = got["state_tree"]["layers"][0], w1["state_tree"][
            "layers"][0]
        B, Lc, kv, hd = whole["k"]
        assert layer["k"] == layer["v"] == (B // R, Lc // M, kv, hd)
        if mamba:
            h, conv = whole["mamba"]["h"], whole["mamba"]["conv"]
            assert layer["mamba"] == dict(h=(B // R, h[1] // M, h[2]),
                                          conv=(B // R, conv[1],
                                                conv[2] // M))
            p = got["param_tree"]["layers"][0]["mamba"]
            d, d_in = cfg.d_model, cfg.d_model
            assert p["in_proj"] == (d, 2 * d_in // M)
            assert p["out_proj"] == p["x_proj"][:1] + (d,) == \
                (d_in // M, d)
            assert p["A_log"] == (d_in // M, cfg.ssm_state)
        else:
            assert got["state_tree"]["memory"] == (B // R,) + w1[
                "state_tree"]["memory"][1:]
            cross = got["param_tree"]["layers"][0]["cross"]
            hd = cfg.resolved_head_dim
            assert cross["wq"] == (cfg.d_model, cfg.n_heads * hd // M)
            assert cross["wo"] == (cfg.n_heads * hd // M, cfg.d_model)


@pytest.mark.parametrize("mesh,name", ON_MESH)
def test_exchanged_bytes_equal_the_plans_count(runs, mesh, name):
    """Each rank's prefill and every engine step exchange over "model"
    exactly what the same step counted on meta structs of the plan's
    blocks before the run (nothing over "data"); the encoder's exchanges
    are the prefill's less the decoder's."""
    for out in runs["ranks"][mesh]:
        got = out[name]
        assert set(got["prefill_predicted"]) == {"model"}
        assert got["prefill_exchanged"] == got["prefill_predicted"]
        assert set(got["step_predicted"]) == {"model"}
        for ex in got["step_exchanged"]:
            assert ex == got["step_predicted"]
        if name == "seamless":
            enc = got["encode_exchanged"]["model"]
            assert 0 < enc["bytes"] < got["prefill_exchanged"]["model"][
                "bytes"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mamba_leaves_placed_off_their_channels_are_gathered_at_use(runs,
                                                                     mesh):
    """A Mamba mixer whose leaves the plan places off their channel dims
    (``tp_ranks.OFF_CHANNELS``: as on other widths or meshes) runs on the
    rank's channels all the same: each such leaf gathered at use, each
    product as its spec says.  The prefill and a decode step (whole on
    every rank) against world 1's within LOGIT_TOL, the state's blocks
    against those channels of world 1's."""
    from repro_torch.models import ssm

    cfg, params, x, x1, state = mixer_inputs(MIXER_SEED)
    with one_thread():
        want = ssm.mamba_scan(params, x, cfg).numpy()
        step, state = ssm.mamba_decode(params, x1, state, cfg)
    (R, M), _ = MESHES[mesh]
    for r, out in enumerate(runs["ranks"][mesh]):
        got, m = out["mixer"], r % M
        np.testing.assert_allclose(got["prefill"], want, atol=LOGIT_TOL,
                                   rtol=0)
        np.testing.assert_allclose(got["step"], step.numpy(),
                                   atol=LOGIT_TOL, rtol=0)
        n = cfg.d_model // M
        cols = slice(m * n, (m + 1) * n)
        np.testing.assert_allclose(got["state"]["h"],
                                   state["h"][:, cols].numpy(),
                                   atol=LOGIT_TOL, rtol=0)
        np.testing.assert_array_equal(got["state"]["conv"],
                                      state["conv"][..., cols].numpy())


def test_a_mamba_state_split_off_its_channels_raises_naming_3d():
    """A decode state the plan splits over "model" on a dim other than its
    channels (as ``long_500k``'s B = 1 would put it on N) raises
    ``NotImplementedError`` naming 7(b) step 3d, before any exchange."""
    from repro_torch.distributed.data_parallel import Axis, RankBlock
    from repro_torch.distributed.sharding import P
    from repro_torch.models import ssm

    cfg, params, _, x1, state = mixer_inputs(MIXER_SEED)
    axis = lambda n, s: Axis(n, None, s, 0, 1)
    ranks = RankBlock(axis("data", 1), axis("model", 2), x1.shape[0],
                      specs={k: P() for k in params},
                      state_specs={"h": P(None, None, "model"),
                                   "conv": P(None, None, "model")})
    with pytest.raises(NotImplementedError, match="7\\(b\\) step 3d"):
        ssm.mamba_decode(params, x1, state, cfg, ranks=ranks)
