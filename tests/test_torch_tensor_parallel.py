"""Tensor-parallel serving over a ("data", "model") mesh on the CPU:
``launch.steps.prefill_setup`` and ``ServeEngine(..., ranks=)`` run as
every rank of a 1 x 2 and a 2 x 2 gloo mesh (``dp_ranks.run_ranks``, one
spawn per mesh, every case of the mesh in one job: ``tp_ranks.tp_job``),
each rank holding its blocks of the reference's smoke weights as
``sharding.local_tree(sharding.place_tree(...))`` gives them.

Cases (``reduce_for_smoke`` configs, 2 layers, d 256, head_dim 64):
SmolLM (4/2 heads: B4 on a rank's heads), a 3/1-head SmolLM (the heads
do not split over 2 ranks: gathered), Gemma (GeGLU, the embedding's
scale), Phi3 (mode B, whose plan also names a one-device ``"data"``
axis) with ``attn_seq_shards=2`` at S = 512 (B4 on a rank's block of
queries) and LLaVA's decoder with its patch prefix (mode B; its
``frontend_proj`` gathered at use): these two on 1 x 2 only.  The decode
cache of 16 positions (the 3/1-head case: a ring of 8) splits over
``"model"`` by positions, so every step runs B5's partial on each rank
and merges.  The engine's 17 steps cross every rank's block: the prompt
and generated tokens land in the blocks of the ranks above 0 (at 2 x 2
too, 8 positions a rank), the full cache's last step overwrites its last
slot (a rank above 0's), the ring wraps twice over both ranks' blocks;
each rank above 0 is checked to have been handed a non-empty block.

Each rank's prefill logits (its rows, its vocabulary block) and the
engine's logits at every step (prompt token by token, then 8 greedy
tokens) are held to the port at world 1 and to the reference's
``forward``/``decode_step`` on one device (teacher-forced with world 1's
tokens) within 2e-5 absolute (f32 sums regrouped over the ranks: the
measured worst is a few 1e-6); the embedding to world 1 bit for bit; the
greedy tokens to world 1's and the reference's, a flip allowed only
where world 1's top two logits are within 1e-5 (counted: none occur).
The exchanges each step counts equal exactly the ones predicted before
the run: the rank's steps, from ``prefill_setup``/``decode_setup``, run
first on ``meta`` structs of its blocks (``tp_ranks.run_case``).
"""
import contextlib
import dataclasses
import functools
import importlib
import io

import numpy as np
import pytest
import torch
from dp_ranks import run_ranks
from test_torch_reference import one_thread
from tp_ranks import SEEDED, SEEDED_L, SEEDED_N, case_cfg, run_case, \
    seeded_decode

from repro_torch.configs import INPUT_SHAPES, InputShape, get_arch
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.context import clear_mesh, set_mesh
from repro_torch.distributed.data_parallel import Axis, RankBlock
from repro_torch.kernels import ref
from repro_torch.launch import dryrun, steps

LOGIT_TOL = 2e-5          # f32 logits, world 1 and the reference
CACHE = 80                # the engine's cache: 45 steps cross every block
PROMPTS = (13, 37)        # the engine's prompt lengths
NEAR_TIE = 1e-5           # a greedy flip is allowed below this top-2 gap
CASES = {
    "smollm": dict(arch="smollm-360m"),
    "gathered": dict(arch="smollm-360m",
                     patch=dict(n_heads=3, n_kv_heads=1, head_dim=64)),
    "gemma": dict(arch="gemma-7b"),
    "phi3_seq": dict(arch="phi3-medium-14b", patch=dict(attn_seq_shards=2),
                     S=512, B=1),
    "llava": dict(arch="llava-next-mistral-7b"),
}
ONE_DATA_RANK = ("phi3_seq", "llava")      # mode B: "data" of one device
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
ON_MESH = [(m, c) for m in MESHES for c in CASES
           if not (m == "2x2" and c in ONE_DATA_RANK)]


@functools.lru_cache(maxsize=None)
def _ref_cfg(name):
    jconfigs = importlib.import_module("repro.configs")
    case = CASES[name]
    return dataclasses.replace(
        jconfigs.reduce_for_smoke(jconfigs.get_arch(case["arch"])),
        **case.get("patch", {}))


def _case(name):
    """The case's inputs, with the reference's ``init_lm`` weights."""
    import jax

    jtr = importlib.import_module("repro.models.transformer")
    case = dict(CASES[name])
    jcfg = _ref_cfg(name)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(case_cfg(case))
    case["weights"] = jax.tree.map(
        np.asarray, jtr.init_lm(jax.random.PRNGKey(7), jcfg))
    rng = np.random.RandomState(len(name))
    V = jcfg.vocab_size
    case["tokens"] = rng.randint(0, V, (case.pop("B", 2), case.pop("S", 12)))
    if jcfg.frontend != "none":
        case["embeds"] = rng.randn(case["tokens"].shape[0],
                                   jcfg.frontend_tokens,
                                   jcfg.d_model).astype(np.float32)
    case["prompts"] = [rng.randint(0, V, n).astype(np.int32)
                       for n in PROMPTS]
    case["max_new"], case["cache_len"] = 8, CACHE
    return case


def _reference(name, case, world1):
    """The reference on one device: the prefill's logits, and each engine
    step's logits fed world 1's tokens (the left-padded prompts, then the
    greedy tokens it drew), and its own engine's greedy tokens."""
    import jax
    import jax.numpy as jnp

    jtr = importlib.import_module("repro.models.transformer")
    jlayers = importlib.import_module("repro.models.layers")
    jserving = importlib.import_module("repro.serving")
    jcfg = _ref_cfg(name)
    jp = jax.tree.map(jnp.asarray, case["weights"])
    inputs = {"tokens": jnp.asarray(case["tokens"])}
    if "embeds" in case:
        inputs["frontend_embeds"] = jnp.asarray(case["embeds"])
    x, _ = jtr.forward(jp, inputs, jcfg)
    prefill = np.asarray(jlayers.lm_logits(jp["embed"], x[:, -1:],
                                           jcfg)[:, 0])
    prompts = case["prompts"]
    n = max(len(p) for p in prompts)
    fed = np.zeros((len(prompts), n), np.int32)
    for i, p in enumerate(prompts):
        fed[i, n - len(p):] = p
    drawn = np.stack(world1["tokens"])
    fed = np.concatenate([fed, drawn], axis=1)
    window = case.get("window", 0)
    step = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg,
                                     window=window))
    state = jtr.init_decode_state(jcfg, len(prompts), case["cache_len"],
                                  jnp.float32, window=window)
    logits = []
    for t in range(fed.shape[1]):
        got, state = step(jp, state, jnp.asarray(fed[:, t:t + 1]),
                          jnp.asarray(t))
        logits.append(np.asarray(got[:, -1]))
    eng = jserving.ServeEngine(jp, jcfg, batch=len(prompts),
                               cache_len=case["cache_len"], window=window)
    toks = eng.generate([jserving.ServeRequest(prompt=p,
                                               max_new=case["max_new"])
                         for p in prompts])
    return dict(prefill=prefill, step_logits=logits,
                tokens=[np.asarray(t) for t in toks])


def _seeded_case():
    """SmolLM's case with seeded K/V caches of SEEDED_L positions (every
    slot filled, as after a long prompt) and the tokens of SEEDED_N
    steps (2 rows)."""
    case = _case("smollm")
    cfg = _ref_cfg("smollm")
    rng = np.random.RandomState(11)
    shape = (cfg.n_layers, 2, SEEDED_L, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    case["kv"] = tuple(rng.randn(*shape).astype(np.float32)
                       for _ in range(2))
    case["seeded_tokens"] = rng.randint(0, cfg.vocab_size, (2, SEEDED_N))
    return case


def _reference_seeded(case):
    """The reference's ``decode_step`` on one device from the same caches
    and tokens: per run, each step's last logits."""
    import jax
    import jax.numpy as jnp

    jtr = importlib.import_module("repro.models.transformer")
    jcfg = _ref_cfg("smollm")
    jp = jax.tree.map(jnp.asarray, case["weights"])
    out = {}
    for name, window, s0 in SEEDED:
        step = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg,
                                         window=window))
        state = {"layers": ({"k": jnp.asarray(case["kv"][0]),
                             "v": jnp.asarray(case["kv"][1])},)}
        logits = []
        for t in range(SEEDED_N):
            got, state = step(jp, state, jnp.asarray(
                case["seeded_tokens"][:, t:t + 1]), jnp.asarray(s0 + t))
            logits.append(np.asarray(got[:, -1]))
        out[name] = logits
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at world 1 and on the reference, and every mesh's ranks
    (one spawn a mesh)."""
    cases = {name: _case(name) for name in CASES}
    seeded = _seeded_case()
    with one_thread():
        world1 = {name: run_case(c) for name, c in cases.items()}
        world1["seeded"] = seeded_decode(seeded)
    ref_runs = {name: _reference(name, c, world1[name])
                for name, c in cases.items()}
    ref_runs["seeded"] = _reference_seeded(seeded)
    tmp = tmp_path_factory.mktemp("tp")
    ranks = {}
    for mesh, shape in MESHES.items():
        names = [c for m, c in ON_MESH if m == mesh]
        ranks[mesh] = run_ranks(shape, "tp_ranks:tp_job", dict(
            cases={n: cases[n] for n in names}, seeded=seeded,
            init_seed=3 if mesh == "1x2" else None), tmp)
    return dict(cases=cases, world1=world1, ref=ref_runs, ranks=ranks)


def _vocab_block(a, m, M):
    V = a.shape[-1] // M
    return a[..., m * V:(m + 1) * V]


def _hold_tokens(got, want, world1_logits, rows):
    """Greedy tokens equal, or a flip where world 1's top two logits sit
    within NEAR_TIE at that step; returns, per row, the step of its
    first flip (None: none) and the flips counted."""
    first, flips = [], 0
    prompt = len(world1_logits) - len(got[0])
    for i, (g, w) in enumerate(zip(got, want)):
        off = np.flatnonzero(np.asarray(g) != np.asarray(w))
        if off.size == 0:
            first.append(None)
            continue
        t = int(off[0])
        top = np.sort(world1_logits[prompt + t - 1][rows[0] + i])[-2:]
        assert top[1] - top[0] < NEAR_TIE, (i, t, top)
        first.append(t)
        flips += 1
    return first, flips


@pytest.mark.parametrize("mesh,name", ON_MESH)
def test_ranks_match_world_one_and_the_reference(runs, mesh, name):
    w1, jr = runs["world1"][name], runs["ref"][name]
    R, M = MESHES[mesh]
    for r, out in enumerate(runs["ranks"][mesh]):
        got = out[name]
        m = r % M
        assert got["structs_match"]
        r0, r1 = got["rows"]
        assert r1 - r0 == runs["cases"][name]["tokens"].shape[0] // R
        # the embedding: one non-zero term a row, world 1's bits
        assert np.array_equal(got["embed"], w1["embed"][r0:r1])
        for want in (w1["prefill"], jr["prefill"]):
            np.testing.assert_allclose(
                got["prefill"], _vocab_block(want[r0:r1], m, M),
                atol=LOGIT_TOL, rtol=0)
        e0, e1 = got["engine_rows"]
        w1_logits = [lg for lg in w1["step_logits"]]
        first, flips = _hold_tokens(got["tokens"], w1["tokens"], w1_logits,
                                    (0, 0))
        _, ref_flips = _hold_tokens(got["tokens"], jr["tokens"], w1_logits,
                                    (0, 0))
        assert flips == ref_flips == 0
        prompt = len(w1["step_logits"]) - runs["cases"][name]["max_new"]
        for t, lg in enumerate(got["step_logits"]):
            live = [i for i in range(e1 - e0) if first[e0 + i] is None
                    or t < prompt + first[e0 + i]]
            for want in (w1["step_logits"][t], jr["step_logits"][t]):
                np.testing.assert_allclose(
                    lg[live], _vocab_block(want[e0:e1], m, M)[live],
                    atol=LOGIT_TOL, rtol=0, err_msg=f"step {t} rank {r}")
        # one B5 partial a layer and step; B4 only in the prefill
        n_steps = len(w1["step_logits"])
        assert got["engine_calls"] == dict(
            flash_attention=0, decode_attention=0,
            decode_attention_partial=2 * n_steps)
        assert got["prefill_calls"]["flash_attention"] == 2
        L = runs["cases"][name].get("window") or CACHE
        assert got["state_shapes"][0] == (2 // R, L // M, *got[
            "state_shapes"][0][2:])
        # every rank's block held positions at some step, none past L/M
        assert 0 < got["partial_len"] <= L // M


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decode_across_rank_blocks_and_the_ring_wrap(runs, mesh):
    """From caches filled at every slot, decode steps that cross from
    rank 0's block of positions into rank 1's, that wrap a ring from
    rank 1's last slots to rank 0's first, and that overwrite the full
    cache's last slot past its end: each rank's logits (its rows, its
    vocabulary block) against world 1 and the reference within
    LOGIT_TOL; every rank is handed a non-empty block."""
    R, M = MESHES[mesh]
    w1, jr = runs["world1"]["seeded"], runs["ref"]["seeded"]
    for name, _, _ in SEEDED:
        for a, b in zip(w1[name]["logits"], jr[name]):
            np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
    for r, out in enumerate(runs["ranks"][mesh]):
        m, rows = r % M, slice((r // M) * 2 // R, (r // M + 1) * 2 // R)
        for name, _, _ in SEEDED:
            got = out["seeded"][name]
            assert 0 < got["partial_len"] <= SEEDED_L // M
            for t, lg in enumerate(got["logits"]):
                for want in (w1[name]["logits"][t], jr[name][t]):
                    np.testing.assert_allclose(
                        lg, _vocab_block(want[rows], m, M), atol=LOGIT_TOL,
                        rtol=0, err_msg=f"{name} step {t} rank {r}")


@pytest.mark.parametrize("mesh,name", ON_MESH)
def test_exchanged_bytes_equal_the_plans_count(runs, mesh, name):
    """Each rank's prefill and every engine step exchange over "model"
    exactly what the same step counted on meta structs of the plan's
    blocks before the run (and nothing over "data")."""
    for out in runs["ranks"][mesh]:
        got = out[name]
        assert set(got["prefill_predicted"]) == {"model"}
        assert got["prefill_predicted"]["model"]["bytes"] > 0
        assert got["prefill_exchanged"] == got["prefill_predicted"]
        assert set(got["step_predicted"]) == {"model"}
        for ex in got["step_exchanged"]:
            assert ex == got["step_predicted"]


def test_rank_weights_are_the_placed_blocks_and_all_gather_counts(runs):
    """``init_lm`` with ``keep_blocks`` draws each leaf whole in world 1's
    order and keeps the rank's block, contiguous: ``place_tree``'s
    values; an
    ``all_gather`` over 2 ranks counts the rank's block's bytes."""
    for r, out in enumerate(runs["ranks"]["1x2"]):
        assert out["init_blocks_equal"]
        got, counted = out["all_gather"]
        want = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3)
                               + 10 * m for m in range(2)], axis=1)
        assert np.array_equal(got, want)
        assert counted == {"model": {"calls": 1, "bytes": 24}}


def test_world_one_is_todays_program():
    """No mesh and the 1 x 1 host mesh run the same program: the prefill
    through ``prefill_setup``, the engine with a one-rank block, the
    same logits, tokens and calls bit for bit (B5 whole, never its
    partial)."""
    from repro_torch.distributed.data_parallel import rank_block
    from repro_torch.launch.mesh import registered_host_mesh
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ServeEngine, ServeRequest
    from tp_ranks import AttentionCalls

    cfg = case_cfg(CASES["smollm"])
    params = tr.init_lm(torch.Generator().manual_seed(1), cfg, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 12)))
    prompts = [np.arange(1, 6, dtype=np.int32), np.arange(7, 16,
                                                          dtype=np.int32)]

    def serve(ranks):
        eng = ServeEngine(params, cfg, batch=2, cache_len=64, device="cpu",
                          ranks=ranks)
        with AttentionCalls() as c:
            got = eng.generate([ServeRequest(prompt=p, max_new=6)
                                for p in prompts])
        return [g.tolist() for g in got], c.counts

    with one_thread():
        plain = steps.make_prefill_step(cfg)(params, {"tokens": toks})
        want = serve(None)
        with registered_host_mesh("cpu") as mesh:
            step, _, _, _ = steps.prefill_setup(
                cfg, InputShape("p", 12, 2, "prefill"), mesh)
            placed = step(params, {"tokens": toks})
            got = serve(rank_block(mesh, 2))
    assert torch.equal(placed, plain)
    assert got == want
    assert want[1] == dict(flash_attention=0, decode_attention=2 * 15,
                           decode_attention_partial=0)


@pytest.mark.parametrize("M", [2, 4, 8])
def test_b5_partials_merge_to_b5_whole(M):
    """The plain partial over M blocks of a cache, merged, is the plain B5
    over the whole cache: rows whose valid positions end in the first
    block leave the other blocks empty (out 0, lse -inf, weight 0)."""
    g = torch.Generator().manual_seed(M)
    B, L, H, Hkv, D = 4, 64, 6, 2, 64
    q = torch.randn((B, H, D), generator=g)
    k = torch.randn((B, L, Hkv, D), generator=g)
    v = torch.randn((B, L, Hkv, D), generator=g)
    length = torch.tensor([1, L // M - 3, L // 2 + 5, L], dtype=torch.int32)
    Lr = L // M
    parts = [ref.decode_attention_partial_ref(
        q, k[:, r * Lr:(r + 1) * Lr], v[:, r * Lr:(r + 1) * Lr],
        (length - r * Lr).clamp(0, Lr)) for r in range(M)]
    empty = parts[-1]
    assert torch.equal(empty[0][0], torch.zeros((H, D)))
    assert bool(torch.isneginf(empty[1][0]).all())
    got = ref.merge_decode_partials([p[0] for p in parts],
                                    [p[1] for p in parts], torch.float32)
    assert bool(torch.isfinite(got).all())
    want = ref.decode_attention_ref(q, k, v, length)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    # a block's lse is the log-sum-exp of its scaled logits
    logits = torch.einsum("bkgd,bskd->bkgs",
                          q.reshape(B, Hkv, H // Hkv, D)
                          * ref.attention_scale(D), k[:, :Lr])
    lse = torch.logsumexp(logits[1, ..., :int(length[1])], dim=-1)
    torch.testing.assert_close(parts[0][1][1], lse.reshape(H), atol=1e-6,
                               rtol=0)


def _fake(shape):
    return dryrun.fake_mesh(shape, ("data", "model"))


LEFT_OUT = {
    "moe_train_default_plan": ("olmoe-1b-7b", "train_4k", (1, 2),
                               "step 3c"),
    "xlstm_train_default_plan": ("xlstm-1.3b", "train_4k", (1, 2),
                                 "step 3c"),
    "mode_b_decode_data": ("llava-next-mistral-7b", "decode_32k", (2, 1),
                           "step 3d"),
    "mode_b_train_data": ("phi3-medium-14b", "train_4k", (2, 2), "step 3d"),
    "mode_b_data": ("phi3-medium-14b", "prefill_32k", (2, 1), "step 3d"),
    "train_default_plan": ("smollm-360m", "train_4k", (1, 2), "step 3c"),
}


@pytest.mark.parametrize("item", sorted(LEFT_OUT))
def test_what_this_slice_leaves_out_raises_naming_its_item(item):
    arch, shape, mesh, step = LEFT_OUT[item]
    with _fake(mesh) as m:
        with pytest.raises(NotImplementedError, match=f"7\\(b\\) {step}"):
            steps.input_specs(get_arch(arch), INPUT_SHAPES[shape], m,
                              n_clients=mesh[0], rank_local=True)


def test_long_500k_and_moe_group_shard_still_raise():
    """``long_500k`` (B = 1) puts "model" on head_dim: the production
    mesh's decode row raises naming step 3d, as a cache split there does
    in the attention.  ``moe_group_shard`` no longer raises: with a fake
    1 x 2 mesh registered, one program's forward with it equals the one
    without it bit for bit (its split over "model" runs in a rank's step:
    ``tests/test_torch_tensor_parallel_moe_xlstm.py``)."""
    from repro_torch.models import transformer as tr

    with pytest.raises(NotImplementedError, match="7\\(b\\) step 3d"):
        dryrun.run_one("smollm-360m", "long_500k", False, out_dir="",
                       verbose=False, smoke=True)
    cfg = case_cfg(dict(arch="granite-moe-3b-a800m",
                        patch=dict(moe_impl="einsum")))
    on = dataclasses.replace(cfg, moe_group_shard=True)
    params = tr.init_lm(torch.Generator().manual_seed(3), cfg, device="cpu")
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512),
                                      generator=torch.Generator()
                                      .manual_seed(4))}
    with one_thread():
        plain, _ = tr.forward_logits(params, inputs, cfg)
        with _fake((1, 2)) as m:
            set_mesh(m)
            try:
                got, _ = tr.forward_logits(params, inputs, on)
            finally:
                clear_mesh()
    assert torch.equal(got, plain)


def test_seq_blocks_follow_the_references_trigger_and_split():
    def block(M):
        axis = lambda n, s: Axis(n, None, s, 0, 1)
        return RankBlock(axis("data", 1), axis("model", M), 1, specs={})

    cfg = dataclasses.replace(case_cfg(CASES["smollm"]), attn_seq_shards=2)
    assert tp.seq_blocks(cfg, 512, block(2)) == 2      # 2 chunks of 256
    assert tp.seq_blocks(cfg, 256, block(2)) == 0      # S <= Q_CHUNK
    assert tp.seq_blocks(cfg, 768, block(2)) == 0      # 3 chunks, 2 shards
    assert tp.seq_blocks(cfg, 512, block(1)) == 0      # one rank: identity
    with pytest.raises(ValueError, match="do not split over 4"):
        tp.seq_blocks(cfg, 512, block(4))


def test_dryrun_decode_32k_on_the_production_mesh():
    """SmolLM-360M's ``decode_32k`` on (16, 16) as rank 0 of 256 under the
    fake backend: the rank holds 8 rows x 2,048 positions of every cache,
    runs B5's partial in each of the 32 layers, and its exchanges over
    "model" are the plan's, counted here in closed form for this row
    (every leaf split over "model": vocabulary, columns of wq/wk/wv and
    w_gate/w_up, rows of wo and w_down, the norms' scales), priced by the
    link model."""
    row = dryrun.run_one("smollm-360m", "decode_32k", False, out_dir="",
                         verbose=False)
    cfg = get_arch("smollm-360m")
    with _fake((16, 16)) as m:
        _, args, _, _ = steps.decode_setup(cfg, INPUT_SHAPES["decode_32k"],
                                           m, rank_local=True)
        specs = steps.serving_specs(cfg, m)
    assert tuple(args[1]["layers"][0]["k"].shape) == (8, 2048, 5, 64)
    assert row["kernels"]["decode_attention_partial"]["launches"] == 32
    assert "decode_attention" not in row["kernels"]
    P = type(specs["final_norm"]["scale"])
    assert specs["embed"] == {"tok": P("model", None)}
    assert specs["layers"][0] == {
        "attn": dict(wq=P(None, "model"), wk=P(None, "model"),
                     wv=P(None, "model"), wo=P("model", None)),
        "ffn": dict(w_gate=P(None, "model"), w_up=P(None, "model"),
                    w_down=P("model", None)),
        "ln1": {"scale": P("model")}, "ln2": {"scale": P("model")}}
    rows, f32, M = 8, 4, 16
    d, H, Hkv, hd = 960, 15, 5, 64
    norm = d // M * f32                        # a scale's block gathered
    layer = (norm                              # ln1
             + rows * (H + 2 * Hkv) * hd // M * f32   # q, k, v gathered
             + rows * H * (hd + 1) * f32       # the partials (out, lse)
             + rows * d * f32                  # wo: one sum
             + norm                            # ln2
             + rows * d * f32)                 # the FFN: one sum
    want = rows * d * f32 + 32 * layer + norm  # embedding sum, final norm
    assert row["collectives"] == {"model": want} and want == 3_113_200
    assert row["t_collective_s"] > 0 and row["chips"] == 256


@pytest.mark.parametrize("M", [8, 16])
def test_llama3_405b_serves_tensor_parallel_on_meta(M):
    """Llama3-405B at full width (128/8 heads; cut to 4 of its 126 layers)
    as rank 0 of a 1 x M fake mesh on meta: at M = 8 the prefill runs B4
    on a rank's heads, at M = 16 (8 KV heads do not split) on every head;
    a decode step runs B5's partial in every layer; the logits are the
    rank's vocabulary block."""
    from repro_torch.roofline.cost import CostCounter

    cfg = dataclasses.replace(get_arch("llama3-405b"), n_layers=4)
    with _fake((1, M)) as m:
        step, args, _, _ = steps.prefill_setup(
            cfg, InputShape("p", 64, 2, "prefill"), m, rank_local=True)
        with CostCounter(args) as c:
            out = step(*args)
        assert tuple(out.shape) == (2, cfg.padded_vocab // M)
        assert c.kernels["flash_attention"].launches == cfg.n_layers
        local = {k: tuple(t.shape)
                 for k, t in args[0]["layers"][0]["attn"].items()}
        step, args, _, _ = steps.decode_setup(
            cfg, InputShape("d", 256, 2, "decode"), m, rank_local=True)
        with CostCounter(args) as c:
            out, _ = step(*args[:3], 255)
        assert tuple(out.shape) == (2, 1, cfg.padded_vocab // M)
        assert c.kernels["decode_attention_partial"].launches == cfg.n_layers
        assert "decode_attention" not in c.kernels
    d, hd = cfg.d_model, cfg.resolved_head_dim
    assert local == {"wq": (d, cfg.n_heads * hd // M),
                     "wk": (d, cfg.n_kv_heads * hd // M),
                     "wv": (d, cfg.n_kv_heads * hd // M),
                     "wo": (cfg.n_heads * hd // M, d)}


def test_serve_cli_under_torchrun_matches_world_one(tmp_path):
    """``launch.serve --mesh 1x2 --backend gloo`` under torchrun (2 CPU
    ranks) prints world 1's tokens, the sampled requests' included."""
    import subprocess
    import sys

    from repro_torch.launch import serve

    argv = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
            "--max-new", "6", "--requests", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), one_thread():
        assert serve.main(argv) == 0
    want = [l for l in buf.getvalue().splitlines() if l.startswith("req")]
    env = dict(__import__("os").environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(steps.__file__).rsplit("/repro_torch/", 1)[0])
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--standalone", "-m", "repro_torch.launch.serve", *argv,
         "--mesh", "1x2", "--backend", "gloo"], capture_output=True,
        text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = [l for l in proc.stdout.splitlines() if l.startswith("req")]
    assert got == want and len(want) == 2
    assert "mesh 1x2" in proc.stdout
