"""Placement on the host mesh, on the CPU: ``launch/mesh.make_host_mesh``
(a 1 x 1 gloo ``DeviceMesh`` here, NCCL on the card), ``distributed.
sharding.named`` / ``place_tree`` / ``local_tree``, the federated round
through ``launch/steps.train_setup`` on placed state, ``launch.train
--variant``, and the mesh knobs ``moe_group_shard`` and
``attn_seq_shards``.

* (d) Two BAFDP rounds of the smoke SmolLM through ``train_setup`` on
  the state ``place_tree`` placed (its local shards are the state's own
  tensors: no copy) equal the unplaced ``make_train_step``'s rounds bit
  for bit, and stay within ``test_torch_lm_train._compare``'s bounds of
  the reference's jitted step run under its own host mesh, registered
  with its ``set_mesh``.
* (e) ``VARIANTS`` is the reference's, field for field, and ``apply``
  gives what the reference's gives; ``launch.train --variant`` applies
  the ``cfg_patch`` only (the reference's launcher reads neither
  ``fed_patch`` nor ``inner_dp``): ``inner_dp+signs8`` trains on the f32
  sign wire, with the losses of the run without a variant.
* (f) ``moe_group_shard`` (Granite's einsum form) and ``attn_seq_shards``
  (SmolLM, 2 shards over a 512-token prompt) give logits bit for bit
  equal to the runs without them under no mesh and under the host mesh,
  within the existing MoE and LM bounds (2e-5) of the reference's run
  with them under its host mesh; the reference's ``moe_group_shard`` is
  a ``with_sharding_constraint`` that needs a JAX context mesh with Auto
  axes (its ``make_host_mesh`` makes Explicit ones, where the constraint
  is an assert), which its run here is given.  Over a 'model' axis of
  two devices (a fake process group) both raise ``NotImplementedError``.

Each test that starts a process group destroys it before it ends
(``registered_host_mesh``, ``test_torch_reference.fake_mesh``).
"""
import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_train import (  # noqa: F401  (fixture)
    C, FED_KNOBS, S, _batches, _cfgs, _compare, _port_batch, _ref_lm_state,
    jref)
from test_torch_reference import (  # noqa: F401  (fixture)
    fake_mesh, flat_items, one_thread, port_state_arrays, ref_state_arrays,
    reference)

from repro_torch.configs import FedConfig, InputShape, get_arch, \
    reduce_for_smoke
from repro_torch.core.fed_state import fed_state_from_numpy
from repro_torch.distributed import context, sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, train
from repro_torch.launch.variants import VARIANTS, get_variant
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_leaves

LOGIT_TOL = 2e-5          # test_torch_moe.LOGIT_TOL, test_torch_lm's ATOL
ROUNDS = 2


def _state_leaves(state):
    return [l for f in state if f is not None for l in tree_leaves(f)]


# ---------------------------------------------------------------------------
# the host mesh and the placements
def test_host_mesh_is_a_one_rank_gloo_mesh_here():
    import torch.distributed as dist

    with mesh_lib.registered_host_mesh("cpu") as mesh:
        assert context.get_mesh() is mesh
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh_lib.axis_sizes(mesh) == {"data": 1, "model": 1}
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        with pytest.raises(RuntimeError, match="already initialised"):
            mesh_lib.make_host_mesh("cpu")
    assert context.get_mesh() is None and not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.make_host_mesh()
        assert not dist.is_initialized()


def test_production_meshes_are_the_reference_topologies():
    assert mesh_lib.axis_sizes(mesh_lib.make_production_mesh()) == {
        "data": 16, "model": 16}
    assert mesh_lib.axis_sizes(mesh_lib.make_production_mesh(
        multi_pod=True)) == {"pod": 2, "data": 16, "model": 16}


def test_named_gives_one_placement_per_mesh_dim_and_refuses_bad_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    assert sh.named(mesh, sh.P(("pod", "data"), None, "model"),
                    (64, 3, 32)) == (Shard(0), Shard(0), Shard(2))
    assert sh.named(mesh, sh.P()) == (Replicate(),) * 3
    assert repr(sh.P("data", None)) == "PartitionSpec('data', None)"
    for spec, shape, match in (
            (sh.P(("data", "pod")), (64,), "axis order"),
            (sh.P("data", "data"), (16, 16), "used twice"),
            (sh.P("rows"), (16,), "not in the mesh"),
            (sh.P("model"), (24,), "evenly"),
            (sh.P(None, None), (4,), "more entries")):
        with pytest.raises(ValueError, match=match):
            sh.named(mesh, spec, shape)


def test_place_tree_on_the_host_mesh_makes_no_copy():
    """Every leaf of a placed tree (a ``FedState`` with ``None`` fields,
    dicts, tuples) is a DTensor whose local shard is the leaf itself."""
    from torch.distributed.tensor import DTensor

    cfg = reduce_for_smoke(get_arch("xlstm-1.3b"))
    fed = steps.fed_config_for(cfg, C)
    with mesh_lib.registered_host_mesh("cpu") as mesh:
        _, (state_sds, _, _), (specs, _, _), _ = steps.train_setup(
            cfg, InputShape("smoke", 32, 4, "train"), mesh, n_clients=C)
        from repro_torch.core.fed_state import init_fed_state, init_lm_tree

        state = init_fed_state(torch.Generator().manual_seed(0),
                               lambda g: init_lm_tree(g, cfg, "cpu"), fed,
                               device="cpu")
        placed = sh.place_tree(state, specs, mesh)
        local = sh.local_tree(placed)
        assert placed.opt is None and local.comp is None
        assert isinstance(placed.W["unit"], tuple)
        for a, p, b in zip(_state_leaves(state), _state_leaves(placed),
                           _state_leaves(local)):
            assert isinstance(p, DTensor) and not isinstance(b, DTensor)
            assert p.shape == a.shape == b.shape
            assert b.data_ptr() == a.data_ptr() and torch.equal(a, b)
        assert [tuple(l.shape) for l in _state_leaves(state_sds)] == [
            tuple(l.shape) for l in _state_leaves(state)]


def test_place_tree_takes_each_ranks_block_as_a_view():
    """On a fake (2, 4) mesh, rank 6 (coordinate (1, 2)) holds rows 4..7
    and columns 4..5 of an (8, 8) tensor as a view, the values with it."""
    x = torch.arange(64.0).reshape(8, 8)
    with fake_mesh((2, 4), ("data", "model"), rank=6) as mesh:
        dt = sh.place_tree({"x": x}, {"x": sh.P("data", "model")}, mesh)["x"]
        local = dt.to_local()
    assert torch.equal(local, x[4:8, 4:6])
    assert local.data_ptr() == x[4:8, 4:6].data_ptr()
    assert tuple(dt.shape) == (8, 8)


# ---------------------------------------------------------------------------
# (d) the round on placed state
def test_host_mesh_round_matches_unplaced_and_reference(reference, jref):
    r = reference
    jcfg, cfg = _cfgs(jref, "smollm-360m")
    jsteps = importlib.import_module("repro.launch.steps")
    jctx = importlib.import_module("repro.distributed.context")
    jmesh = importlib.import_module("repro.launch.mesh")
    knobs = dict(FED_KNOBS, privacy_budget_a=1e18, active_frac=1.0)
    fed_j = dataclasses.replace(jsteps.fed_config_for(jcfg, C), **knobs)
    fed = dataclasses.replace(steps.fed_config_for(cfg, C), **knobs)
    batches = _batches(cfg, ROUNDS, S)
    state = _ref_lm_state(r, jcfg, fed_j)
    init = ref_state_arrays(state)

    jctx.set_mesh(jmesh.make_host_mesh())
    try:
        jstep = jax.jit(jsteps.make_train_step(jcfg, fed_j))
        ref_states, ref_metrics = [], []
        for t in range(ROUNDS):
            state, m = jstep(state, {k: jnp.asarray(v)
                                     for k, v in batches[t].items()},
                             jnp.asarray(t))
            ref_states.append(ref_state_arrays(state))
            ref_metrics.append({k: np.asarray(v) for k, v in m.items()})
    finally:
        jctx.clear_mesh()

    runs = {}
    with one_thread():
        step = steps.make_train_step(cfg, fed)
        pstate = fed_state_from_numpy(init, device="cpu")
        runs["unplaced"] = []
        for t in range(ROUNDS):
            pstate, m = step(pstate, _port_batch(batches[t]), t)
            runs["unplaced"].append((port_state_arrays(pstate), m))
        shape = InputShape("smoke", S, C * batches[0]["tokens"].shape[1],
                           "train")
        with mesh_lib.registered_host_mesh("cpu") as mesh:
            pstep, _, (s_specs, b_specs, _), _ = steps.train_setup(
                cfg, shape, mesh, base_fed=FedConfig(**knobs), n_clients=C)
            pstate = fed_state_from_numpy(init, device="cpu")
            local = sh.local_tree(sh.place_tree(pstate, s_specs, mesh))
            for a, b in zip(_state_leaves(pstate), _state_leaves(local)):
                assert b.data_ptr() == a.data_ptr() and b.shape == a.shape
            runs["placed"] = []
            for t in range(ROUNDS):
                batch = sh.local_tree(sh.place_tree(
                    _port_batch(batches[t]), b_specs, mesh))
                local, m = pstep(local, batch, t)
                runs["placed"].append((port_state_arrays(local), m))
    for (a, ma), (b, mb) in zip(runs["placed"], runs["unplaced"]):
        for key in a:
            for (path, x), (_, y) in zip(flat_items(a[key]),
                                         flat_items(b[key])):
                np.testing.assert_array_equal(x, y, err_msg=key + path)
        for k in mb:
            assert torch.equal(ma[k], mb[k]), k
    _compare(init, [s for s, _ in runs["placed"]],
             [{k: v.numpy() for k, v in m.items()}
              for _, m in runs["placed"]], ref_states, ref_metrics, fed)


# ---------------------------------------------------------------------------
# (e) variants
def test_variants_are_the_reference_copy(reference):
    jv = importlib.import_module("repro.launch.variants")
    jconfigs = importlib.import_module("repro.configs")
    assert list(VARIANTS) == list(jv.VARIANTS)
    for name, v in VARIANTS.items():
        assert dataclasses.asdict(v) == dataclasses.asdict(jv.VARIANTS[name])
        for arch in ("smollm-360m", "granite-moe-3b-a800m"):
            cfg, fed, kw = get_variant(name).apply(get_arch(arch),
                                                   FedConfig())
            jcfg, jfed, jkw = jv.get_variant(name).apply(
                jconfigs.get_arch(arch), jconfigs.FedConfig())
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert dataclasses.asdict(fed) == dataclasses.asdict(jfed)
            assert kw == jkw
    with pytest.raises(KeyError):
        get_variant("v")


def _train_lines(capsys, argv, monkeypatch):
    """``launch.train.main(argv)`` on the CPU: its printed losses, the
    config and ``inner_dp`` that reached ``train_setup``, and the sign
    wire of every consensus call."""
    from repro_torch.kernels import ops

    seen = {"messages": []}
    real_setup, real_sign = steps.train_setup, ops.sign_consensus_leaves

    def setup(cfg, shape, mesh, base_fed=None, inner_dp=False, **kw):
        seen.update(cfg=cfg, inner_dp=inner_dp)
        return real_setup(cfg, shape, mesh, base_fed, inner_dp, **kw)

    def sign(*args, message="f32", **kw):
        seen["messages"].append(message)
        return real_sign(*args, message=message, **kw)

    capsys.readouterr()
    with monkeypatch.context() as mp, one_thread():
        mp.setattr(steps, "train_setup", setup)
        mp.setattr(ops, "sign_consensus_leaves", sign)
        assert train.main(argv) == 0
    lines = [l.split("  ")[:4] for l in capsys.readouterr().out.splitlines()]
    return lines, seen


@pytest.mark.parametrize("variant", ["inner_dp+signs8",
                                     "inner_dp+signs8+noremat"])
def test_train_cli_variant_applies_the_cfg_patch_only(capsys, monkeypatch,
                                                      variant):
    argv = ["--arch", "smollm-360m", "--smoke", "--steps", "3",
            "--log-every", "1", "--device", "cpu"]
    base, seen0 = _train_lines(capsys, argv, monkeypatch)
    lines, seen = _train_lines(capsys, argv + ["--variant", variant],
                               monkeypatch)
    v = VARIANTS[variant]
    assert v.inner_dp and v.fed_patch == {"sign_message": "int8"}
    assert seen["cfg"] == dataclasses.replace(seen0["cfg"], **v.cfg_patch)
    assert not (seen["cfg"].remat and "noremat" in variant)
    assert seen["inner_dp"] is False
    assert seen["messages"] == seen0["messages"] == ["f32"] * 3
    assert lines == base and len(lines) == 4     # remat changes no value


# ---------------------------------------------------------------------------
# (f) the mesh knobs
def _ref_logits(jcfg, toks, knob):
    """The reference's forward logits with ``knob`` set, under its host
    mesh (registered), and for ``moe_group_shard`` an Auto-axis (1, 1)
    JAX context mesh."""
    jtr = importlib.import_module("repro.models.transformer")
    jctx = importlib.import_module("repro.distributed.context")
    jmesh = importlib.import_module("repro.launch.mesh")
    tree = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    auto = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    # the constraint needs the context mesh; shard_map (the sequence
    # shards) takes the registered mesh and refuses another in context
    context_mesh = jax.set_mesh(auto) if "moe_group_shard" in knob \
        else contextlib.nullcontext()
    jctx.set_mesh(jmesh.make_host_mesh())
    try:
        with context_mesh:
            out, _ = jtr.forward_logits(
                tree, {"tokens": jnp.asarray(toks)},
                dataclasses.replace(jcfg, **knob))
    finally:
        jctx.clear_mesh()
    return jax.tree.map(np.asarray, tree), np.asarray(out)


KNOBS = {"moe_group_shard": ("granite-moe-3b-a800m",
                             {"moe_impl": "einsum"},
                             {"moe_group_shard": True}, (2, 512)),
         "attn_seq_shards": ("smollm-360m", {}, {"attn_seq_shards": 2},
                             (1, 512))}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_mesh_knobs_are_the_identity_on_one_device(reference, knob):
    arch, base, patch, (B, T) = KNOBS[knob]
    jconfigs = importlib.import_module("repro.configs")
    jcfg = dataclasses.replace(
        jconfigs.reduce_for_smoke(jconfigs.get_arch(arch)), **base)
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), **base)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, T))
    tree, want = _ref_logits(jcfg, toks, patch)
    params = tr.lm_params_from_numpy(tree, cfg, device="cpu")
    inputs = {"tokens": torch.from_numpy(toks)}
    on = dataclasses.replace(cfg, **patch)
    with one_thread():
        plain, _ = tr.forward_logits(params, inputs, cfg)
        got, _ = tr.forward_logits(params, inputs, on)
        with mesh_lib.registered_host_mesh("cpu"):
            placed, _ = tr.forward_logits(params, inputs, on)
    assert torch.equal(got, plain) and torch.equal(placed, plain)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    with fake_mesh((1, 2), ("data", "model")) as mesh:
        context.set_mesh(mesh)
        try:
            with pytest.raises(NotImplementedError,
                               match=f"{knob}.*not yet ported"):
                tr.forward_logits(params, inputs, on)
            tr.forward_logits(params, inputs, cfg)         # no knob: runs
        finally:
            context.clear_mesh()
