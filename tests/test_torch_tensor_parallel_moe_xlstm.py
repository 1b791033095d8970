"""Tensor-parallel serving of the MoE families and xLSTM over a ("data",
"model") mesh on the CPU: ``launch.steps.prefill_setup`` and
``ServeEngine(..., ranks=)`` as every rank of a 1 x 2 gloo mesh (every
case in one spawn) and of a 2 x 2 one (the batch's rows split over
"data" too), each rank holding its blocks of the reference's smoke
weights (``tp_ranks.tp_job``).

Cases (``reduce_for_smoke`` configs, 2 layers, d 256, f32):
Granite-MoE-3B-a800m and OLMoE-1B-7B (4 experts, top 2: the plan splits
the expert leaves on E, so each rank runs 2 experts), each in the
scatter form (the configs' default) and the einsum form; a copy with 5
experts (the plan splits ``w_gate``/``w_up`` on d_ff and ``w_down`` on
its input: the d_ff-parallel form); the einsum form under
``moe_group_shard`` at a prefill of 2 x 512 tokens (two groups of 512,
one a "model" rank) and in decode steps (one group: rank 0 computes it,
rank 1 none); xLSTM-1.3B (an mLSTM and an sLSTM layer: the mLSTM on a
rank's v rows of each head, the sLSTM on its channels of each gate).
The prefill is 2 x 12 tokens (at 2 x 2 a "data" rank holds half of the
einsum form's one group of 24, so its positions count after the other
rank's pairs); the engine's cache of 64 positions splits over "model" by
positions and its 36 steps reach rank 1's block.

The two meshes' spawns run at once.  Each rank's prefill logits (its
rows, its vocabulary block) and the
engine's logits at every step are held to the port at world 1 within
2e-5 absolute and to the reference on one device within 2e-5 absolute
and relative (its ``forward``, its decode teacher-forced with world 1's
tokens; ``moe_group_shard``'s case against the reference's einsum form
without the knob, which changes no value in one program); the greedy
tokens equal world 1's and the reference's (a flip allowed only at a
near-tie: none occur).  Every routing a rank makes (experts, positions,
kept slots) equals world 1's for the same tokens exactly: the router is
gathered, never a regrouped sum.  Each rank holds only its blocks of
the weights and of the decode state; its exchanges at every step equal
the ones the same step counts first on ``meta`` structs of its blocks;
its launches are B4 in every attention layer of the prefill and B5's
partial in every attention layer of a step (xLSTM: none).  xLSTM also
decodes 4 steps from a seeded random state (``C`` not symmetric: a
transposed C fails, trap X), each rank's logits and blocks of the state
held to world 1's and the reference's.
"""
import dataclasses
import functools
import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from dp_ranks import run_ranks
from test_torch_reference import one_thread
from test_torch_tensor_parallel import LOGIT_TOL, _hold_tokens, _vocab_block
from tp_ranks import SEEDED_N, case_cfg, recurrent_decode, run_case

from repro_torch.configs.base import MoEConfig

REF_TOL = dict(atol=2e-5, rtol=2e-5)     # the reference tests' model bound
CACHE = 64                 # 32 positions a "model" rank
PROMPTS = (11, 30)         # with 6 new tokens: 36 steps
MAX_NEW = 6
GRANITE, OLMOE, XLSTM = "granite-moe-3b-a800m", "olmoe-1b-7b", "xlstm-1.3b"
EINSUM = dict(moe_impl="einsum")
CASES = {"granite": dict(arch=GRANITE),
         "granite_einsum": dict(arch=GRANITE, patch=EINSUM),
         "olmoe": dict(arch=OLMOE),
         "olmoe_einsum": dict(arch=OLMOE, patch=EINSUM),
         "odd_experts": dict(arch=OLMOE, patch=dict(
             moe=MoEConfig(n_experts=5, top_k=2))),
         "group_shard": dict(arch=GRANITE, patch=dict(
             EINSUM, moe_group_shard=True), S=512),
         "xlstm": dict(arch=XLSTM)}
MOE_CASES = [c for c in CASES if c != "xlstm"]
MESHES = {"1x2": ((1, 2), tuple(CASES)),
          "2x2": ((2, 2), ("granite", "granite_einsum", "olmoe",
                           "olmoe_einsum", "group_shard", "xlstm"))}
ON_MESH = [(m, c) for m, (_, names) in MESHES.items() for c in names]
# the reference's engine and teacher-forced decode (one jit each) for the
# three families' default forms; the other cases' world 1 is held to the
# reference's prefill here and to its MoE forms in test_torch_moe.py
REF_DECODE = ("granite", "olmoe", "xlstm")
STATE_SEED = 31


def _patch(name, jconfigs=None):
    """The case's config patch, its MoE config the reference's where
    ``jconfigs`` is given; ``moe_group_shard`` dropped for the
    reference (one program: the identity)."""
    patch = dict(CASES[name].get("patch", {}))
    if jconfigs is not None:
        patch.pop("moe_group_shard", None)
        if "moe" in patch:
            patch["moe"] = jconfigs.MoEConfig(
                **dataclasses.asdict(patch["moe"]))
    return patch


@functools.lru_cache(maxsize=None)
def _ref_cfg(name):
    jconfigs = importlib.import_module("repro.configs")
    return dataclasses.replace(
        jconfigs.reduce_for_smoke(jconfigs.get_arch(CASES[name]["arch"])),
        **_patch(name, jconfigs))


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The reference's ``init_lm`` weights of the case's config, drawn
    once per config (``moe_impl`` and ``moe_group_shard`` draw none)."""
    import jax

    same = [n for n in CASES if _ref_cfg(n) == dataclasses.replace(
        _ref_cfg(name), moe_impl=_ref_cfg(n).moe_impl)]
    if same[0] != name:
        return _weights(same[0])
    jtr = importlib.import_module("repro.models.transformer")
    return jax.tree.map(np.asarray,
                        jtr.init_lm(jax.random.PRNGKey(11), _ref_cfg(name)))


def _case(name):
    """The case's inputs, with the reference's ``init_lm`` weights."""
    case = dict(CASES[name])
    jcfg = _ref_cfg(name)
    plain = dataclasses.replace(case_cfg(case), moe_group_shard=False)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(plain)
    case["weights"] = _weights(name)
    rng = np.random.RandomState(len(name) + 200)
    V = jcfg.vocab_size
    case["tokens"] = rng.randint(0, V, (2, case.pop("S", 12)))
    case["prompts"] = [rng.randint(0, V, n).astype(np.int32)
                       for n in PROMPTS]
    case["max_new"], case["cache_len"] = MAX_NEW, CACHE
    return case


def _random_state(case):
    """xLSTM's decode state of 2 rows, every leaf seeded normals (C not
    symmetric), in the port's layout, and the reference's stacked one."""
    import jax.numpy as jnp

    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_map

    jtr = importlib.import_module("repro.models.transformer")
    cfg = case_cfg(case)
    rng = np.random.RandomState(STATE_SEED)
    state = tree_map(lambda t: rng.randn(*t.shape).astype(np.float32),
                     tr.init_decode_state(cfg, 2, CACHE, torch.float32,
                                          device="meta"))
    jstate = jtr.init_decode_state(_ref_cfg("xlstm"), 2, CACHE, jnp.float32)
    unit = len(jstate["layers"])
    for i, layer in enumerate(state["layers"]):
        for kind, leaves in layer.items():
            for k, a in leaves.items():
                ref = jstate["layers"][i % unit][kind]
                ref[k] = ref[k].at[i // unit].set(jnp.asarray(a))
    return state, jstate


def _reference(name, case, world1):
    """The reference on one device: the prefill's logits; for REF_DECODE
    each engine step's logits fed world 1's tokens (the left-padded
    prompts, then the greedy tokens it drew) and its own engine's greedy
    tokens."""
    import jax
    import jax.numpy as jnp

    jtr = importlib.import_module("repro.models.transformer")
    jlayers = importlib.import_module("repro.models.layers")
    jserving = importlib.import_module("repro.serving")
    jcfg = _ref_cfg(name)
    jp = jax.tree.map(jnp.asarray, case["weights"])
    x, _ = jtr.forward(jp, {"tokens": jnp.asarray(case["tokens"])}, jcfg)
    out = dict(prefill=np.asarray(jlayers.lm_logits(jp["embed"], x[:, -1:],
                                                    jcfg)[:, 0]))
    if name not in REF_DECODE:
        return out
    prompts = case["prompts"]
    n = max(len(p) for p in prompts)
    fed = np.zeros((len(prompts), n), np.int32)
    for i, p in enumerate(prompts):
        fed[i, n - len(p):] = p
    fed = np.concatenate([fed, np.stack(world1["tokens"])], axis=1)
    step = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
    state = jtr.init_decode_state(jcfg, len(prompts), CACHE, jnp.float32)
    logits = []
    for t in range(fed.shape[1]):
        got, state = step(jp, state, jnp.asarray(fed[:, t:t + 1]),
                          jnp.asarray(t))
        logits.append(np.asarray(got[:, -1]))
    eng = jserving.ServeEngine(jp, jcfg, batch=len(prompts), cache_len=CACHE)
    toks = eng.generate([jserving.ServeRequest(prompt=p, max_new=MAX_NEW)
                         for p in prompts])
    out.update(step_logits=logits, tokens=[np.asarray(t) for t in toks])
    if name == "xlstm":             # the decode from a random state
        jstate = case["jstate"]
        rec = []
        for t in range(SEEDED_N):
            got, jstate = step(jp, jstate, jnp.asarray(
                case["seeded_tokens"][:, t:t + 1]), jnp.asarray(t))
            rec.append(np.asarray(got[:, -1]))
        out["recurrent"] = rec
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at world 1 and on the reference, and every mesh's ranks
    (one spawn a mesh)."""
    cases = {name: _case(name) for name in CASES}
    rec = dict(cases["xlstm"])
    rec["state"], jstate = _random_state(rec)
    rec["seeded_tokens"] = np.random.RandomState(STATE_SEED + 1).randint(
        0, rec["weights"]["embed"]["tok"].shape[0], (2, SEEDED_N))
    with one_thread():
        world1 = {name: run_case(c) for name, c in cases.items()}
        world1["recurrent"] = recurrent_decode(rec)
    cases["xlstm"].update(jstate=jstate, seeded_tokens=rec["seeded_tokens"])
    ref_runs = {name: _reference(name, c, world1[name])
                for name, c in cases.items()}
    del cases["xlstm"]["jstate"]
    tmp = tmp_path_factory.mktemp("tp_moe_xlstm")
    with ThreadPoolExecutor(len(MESHES)) as pool:     # both spawns at once
        futures = {mesh: pool.submit(run_ranks, shape, "tp_ranks:tp_job",
                                     dict(cases={n: cases[n] for n in names},
                                          recurrent=rec), tmp)
                   for mesh, (shape, names) in MESHES.items()}
        ranks = {mesh: f.result() for mesh, f in futures.items()}
    return dict(cases=cases, world1=world1, ref=ref_runs, ranks=ranks,
                recurrent=rec)


def _close_to_both(got, w1, jr, err_msg=""):
    np.testing.assert_allclose(got, w1, atol=LOGIT_TOL, rtol=0,
                               err_msg=err_msg)
    if jr is not None:
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
        _close_to_both(got["prefill"],
                       _vocab_block(w1["prefill"][r0:r1], m, M),
                       _vocab_block(jr["prefill"][r0:r1], m, M),
                       f"prefill rank {r}")
        e0, e1 = got["engine_rows"]
        first, flips = _hold_tokens(got["tokens"], w1["tokens"],
                                    w1["step_logits"], (0, 0))
        assert flips == 0
        if "tokens" in jr:
            _, ref_flips = _hold_tokens(got["tokens"], jr["tokens"],
                                        w1["step_logits"], (0, 0))
            assert ref_flips == 0
        assert len(got["step_logits"]) == max(PROMPTS) + MAX_NEW
        for t, lg in enumerate(got["step_logits"]):
            ref = jr["step_logits"][t][e0:e1] if "step_logits" in jr \
                else None
            _close_to_both(lg, _vocab_block(w1["step_logits"][t][e0:e1],
                                            m, M),
                           None if ref is None else _vocab_block(ref, m, M),
                           f"step {t} rank {r}")
        if name != "xlstm":       # every rank's cache block was reached
            assert 0 < got["partial_len"] <= CACHE // M


def _want_routes(name, w1_calls, cfg, rows, M, m, n_tokens):
    """World 1's routings as the rank should have made them: per call,
    its rows' tokens (``rows`` of the call's ``n_tokens``-token rows);
    under ``moe_group_shard`` the tokens of the rank's block of the
    groups (none past the end), whatever its "data" rows."""
    out = []
    for call in w1_calls:
        T, k = call[0].shape
        if CASES[name].get("patch", {}).get("moe_group_shard"):
            gs = min(512, T)
            G = T // gs
            per = -(-G // M)
            a, b = min(m * per, G), min((m + 1) * per, G)
            if b > a:
                out.append(tuple(t[a * gs:b * gs] for t in call))
            continue
        out.append(tuple(t.reshape(-1, n_tokens, k)[rows[0]:rows[1]]
                         .reshape(-1, k) for t in call))
    return out


@pytest.mark.parametrize("mesh,name", [(m, c) for m, c in ON_MESH
                                       if c in MOE_CASES])
def test_routing_equals_world_ones_exactly(runs, mesh, name):
    """Each rank routes as world 1 does, bit for bit: experts, positions
    in them (counted over the whole call's tokens, the "data" ranks
    before it included) and kept slots, in the prefill and in every
    engine step; no flip."""
    cfg = case_cfg(CASES[name])
    w1 = runs["world1"][name]
    (R, M), _ = MESHES[mesh]
    S = runs["cases"][name]["tokens"].shape[1]
    assert len(w1["prefill_routes"]) == cfg.n_layers
    for r, out in enumerate(runs["ranks"][mesh]):
        got, m = out[name], r % M
        for phase, rows, n in (("prefill", got["rows"], S),
                               ("engine", got["engine_rows"], 1)):
            want = _want_routes(name, w1[f"{phase}_routes"], cfg, rows, M,
                                m, n)
            mine = got[f"{phase}_routes"]
            assert len(mine) == len(want) > 0 or (m > 0 and not want)
            for a, b in zip(mine, want):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y, err_msg=(
                        f"{phase} rank {r}"))


def _moe_shapes(cfg, M):
    """The rank's blocks of one MoE layer's leaves under the default plan:
    expert-parallel where M divides E, else d_ff-parallel."""
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    if E % M == 0:
        w = dict(w_gate=(E // M, d, f), w_up=(E // M, d, f),
                 w_down=(E // M, f, d))
    else:
        w = dict(w_gate=(E, d, f // M), w_up=(E, d, f // M),
                 w_down=(E, f // M, d))
    return dict(w, router=(d // M, E))


@pytest.mark.parametrize("mesh,name", ON_MESH)
def test_launches_and_rank_blocks(runs, mesh, name):
    """B4 in every attention layer of the prefill and one B5 partial an
    attention layer and step (xLSTM: no launch); each rank holds its
    blocks of the weights (the MoE leaves on E, or on d_ff for 5
    experts; the mLSTM's and sLSTM's columns and rows) and of the decode
    state (the caches by positions; the mLSTM's C on its v index, n on
    its k index, m on the heads; the sLSTM's state on d)."""
    cfg = case_cfg(CASES[name])
    w1 = runs["world1"][name]
    (R, M), _ = MESHES[mesh]
    L, n_steps = cfg.n_layers, max(PROMPTS) + MAX_NEW
    attn = 0 if name == "xlstm" else L
    pre = dict(flash_attention=attn, decode_attention=0,
               decode_attention_partial=0)
    eng = dict(flash_attention=0, decode_attention=0,
               decode_attention_partial=attn * n_steps)
    assert w1["prefill_calls"] == pre
    assert w1["engine_calls"] == dict(eng, decode_attention=attn * n_steps,
                                      decode_attention_partial=0)
    d, B = cfg.d_model, 2
    for out in runs["ranks"][mesh]:
        got = out[name]
        assert got["prefill_calls"] == pre
        assert got["engine_calls"] == eng
        params, state = got["param_tree"]["layers"], got["state_tree"][
            "layers"]
        if name == "xlstm":
            H = cfg.mlstm_heads
            hd = 2 * d // H
            assert params[0]["mlstm"] == dict(
                up_proj=(d, 4 * d // M), wq=(2 * d, 2 * d // M),
                wk=(2 * d, 2 * d // M), wv=(2 * d, 2 * d // M),
                w_igate=(2 * d // M, H), w_fgate=(2 * d // M, H),
                igate_bias=(H // M,), fgate_bias=(H // M,),
                down_proj=(2 * d // M, d))
            assert params[1]["slstm"] == dict(
                w_in=(d, 4 * d // M), w_rec=(d, 4 * d // M),
                bias=(4 * d // M,), out_proj=(d // M, d))
            assert state[0]["mlstm"] == dict(C=(B // R, H, hd // M, hd),
                                             n=(B // R, H, hd // M),
                                             m=(B // R, H // M))
            assert state[1]["slstm"] == dict.fromkeys("hcnm",
                                                      (B // R, d // M))
            continue
        assert params[0]["moe"] == _moe_shapes(cfg, M)
        B_, Lc, kv, hd = w1["state_tree"]["layers"][0]["k"]
        assert state[0]["k"] == state[0]["v"] == (B_ // R, Lc // M, kv, hd)


@pytest.mark.parametrize("mesh,name", ON_MESH)
def test_exchanged_bytes_equal_the_plans_count(runs, mesh, name):
    """Each rank's prefill and every engine step exchange exactly what the
    same step counted on meta structs of the plan's blocks before the
    run.  At 2 x 2 an MoE prefill also exchanges over "data" (the
    expert counts of the ranks before, or ``moe_group_shard``'s rows),
    nothing else does."""
    (R, _), _ = MESHES[mesh]
    over_data = R > 1 and name in MOE_CASES
    for out in runs["ranks"][mesh]:
        got = out[name]
        axes = {"model", "data"} if over_data else {"model"}
        assert set(got["prefill_predicted"]) == axes
        assert got["prefill_exchanged"] == got["prefill_predicted"]
        assert set(got["step_predicted"]) == axes
        for ex in got["step_exchanged"]:
            assert ex == got["step_predicted"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_xlstm_decodes_from_a_random_state(runs, mesh):
    """xLSTM's 4 decode steps from the seeded random state: each rank's
    logits within 2e-5 of world 1's and of the reference's, and its
    blocks of the state after them (C's rows of the v index, n's block
    of the k index, m's heads, the sLSTM's channels) within 2e-5 of
    those of world 1's state."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.data_parallel import Axis, RankBlock
    from repro_torch.distributed.sharding import map_leaves
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.tree import tree_leaves

    w1, jr = runs["world1"]["recurrent"], runs["ref"]["xlstm"]["recurrent"]
    (R, M), _ = MESHES[mesh]
    cfg = case_cfg(CASES["xlstm"])
    with fake_mesh((R, M), ("data", "model")) as m:
        specs = steps.decode_state_specs(cfg, m, 2, CACHE)
    for r, out in enumerate(runs["ranks"][mesh]):
        got = out["recurrent"]
        axis = lambda n, s, i: Axis(n, None, s, i, 1)
        ranks = RankBlock(axis("data", R, r // M), axis("model", M, r % M),
                          2)
        rows = ranks.clients()
        for t, lg in enumerate(got["logits"]):
            _close_to_both(lg, _vocab_block(w1["logits"][t][rows], r % M, M),
                           _vocab_block(jr[t][rows], r % M, M),
                           f"step {t} rank {r}")
        want = map_leaves(lambda a, sp: tp.block(torch.from_numpy(a), sp,
                                                 ranks).numpy(),
                          w1["state"], specs)
        for a, b in zip(tree_leaves(got["state"]), tree_leaves(want)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
    for t, lg in enumerate(w1["logits"]):
        np.testing.assert_allclose(lg, jr[t], **REF_TOL)


def test_dryrun_moe_rows_on_the_production_mesh():
    """OLMoE-1B-7B's ``decode_32k`` (full width; expert-parallel, 4 of 64
    experts a rank) and Granite-MoE's ``prefill_32k --smoke`` (4 experts
    do not split over 16: d_ff-parallel) on (16, 16) as rank 0 of 256
    under the fake backend.  Their exchanges are counted here in closed
    form: over "model" the embedding's sum, each norm's scale gathered,
    the attention's (q, k, v gathered for B5's partial over the rank's
    2,048 positions, the partials' (out, lse), ``wo``'s sum; at the smoke
    prefill's 4/2 heads, which do not split over 16, the q/k/v products
    gathered and ``wo``'s sum), the router gathered and y's one sum; over
    "data" each MoE layer's expert counts (int64) of the ranks' pairs."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.dryrun import fake_mesh

    row = dryrun.run_one(OLMOE, "decode_32k", False, out_dir="",
                         verbose=False)
    rows, f32, bf16, i64, M = 8, 4, 2, 8, 16
    d, H, hd, E, L = 2048, 16, 128, 64, 16
    norm = d // M * f32
    layer = (norm + rows * 3 * H * hd // M * bf16     # ln1; q, k, v
             + rows * H * (hd + 1) * f32 + rows * d * f32   # partials; wo
             + norm + d // M * E * f32 + rows * d * f32)    # ln2; router; y
    want = rows * d * f32 + L * layer + norm
    assert row["collectives"] == {"model": want, "data": L * E * i64}
    assert want == 3_858_944
    assert row["kernels"]["decode_attention_partial"]["launches"] == L
    assert row["fits"]

    row = dryrun.run_one(GRANITE, "prefill_32k", False, out_dir="",
                         verbose=False, smoke=True)
    cfg = case_cfg(dict(arch=GRANITE))
    with fake_mesh((16, 16), ("data", "model")) as m:
        moe = steps.serving_specs(cfg, m)["layers"][0]["moe"]
    P = type(moe["router"])
    assert moe == dict(router=P("model", None), w_gate=P(None, None, "model"),
                       w_up=P(None, None, "model"),
                       w_down=P(None, "model", None))
    tokens, d, H, Hkv, hd, E, L = 2 * 64, 256, 4, 2, 64, 4, 2
    norm = d // M * f32
    layer = (norm + tokens * (H + 2 * Hkv) * hd // M * f32   # ln1; q, k, v
             + tokens * d * f32                              # wo's sum
             + norm + d // M * E * f32 + tokens * d * f32)   # ln2; router; y
    want = tokens * d * f32 + L * layer + norm
    assert row["collectives"] == {"model": want, "data": L * E * i64}
    assert want == 688_960 and get_arch(GRANITE).moe.n_experts % M
    assert row["kernels"]["flash_attention"]["launches"] == L


def test_dryrun_xlstm_prefill_on_the_production_mesh():
    """xLSTM-1.3B's ``prefill_32k --smoke`` on (16, 16) as rank 0: its
    sLSTM layer's step loop gathers h and the recurrent product over
    "model" once a position each, the mLSTM layer runs on the rank's v
    rows, and no kernel is launched (the dry-run ``chip_smoke.py`` leaves
    this row to)."""
    from repro_torch.launch import dryrun

    row = dryrun.run_one(XLSTM, "prefill_32k", False, out_dir="",
                         verbose=False, smoke=True)
    assert row["kernels"] == {} and row["chips"] == 256 and row["fits"]
    # 2 rows x 64 positions a rank: an all-gather of h (2 x 256 / 16 f32
    # channels) and of the recurrent product (2 x 1,024 / 16) a position
    # in the one sLSTM layer, among the rest
    assert row["collectives"]["model"] > 64 * 2 * (256 + 1024) // 16 * 4
    assert set(row["collectives"]) == {"model"}


def test_a_half_row_parallel_term_rounds_its_weight_first():
    """A bf16 row-parallel product of an f32 leaf: each rank's term in
    f32 of the weight rounded to bf16, as world 1's ``x @ w.to(x.dtype)``
    rounds it, so the terms' sum, rounded once, is world 1's product but
    for a few last-bit ties.  Widening the f32 weight itself moved ~40 %
    of the outputs (and flipped Granite's routing far from a tie on the
    card)."""
    from repro_torch.distributed import tensor_parallel as tp

    g = torch.Generator().manual_seed(5)
    x = torch.randn((64, 512), generator=g).to(torch.bfloat16)
    w = torch.randn((512, 256), generator=g) / 512 ** 0.5
    world1 = x @ w.to(torch.bfloat16)
    terms = [tp._partial(x[:, i:i + 256], w[i:i + 256]) for i in (0, 256)]
    assert all(t.dtype == torch.float32 for t in terms)
    torch.testing.assert_close(terms[0], x[:, :256].float()
                               @ w[:256].to(torch.bfloat16).float(),
                               rtol=0, atol=0)
    summed = (terms[0] + terms[1]).to(torch.bfloat16)
    assert float((summed != world1).float().mean()) < 0.01
