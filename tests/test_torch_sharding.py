"""The port's sharding plan (``distributed/sharding.py``, ``launch/mesh.py``
and ``launch/steps``' setups) against the JAX package's, on the CPU, for
the ten architectures of ``configs/`` at full width, shapes only.

(a) Spec parity, exact.  On the host (1, 1), the pod (16, 16) and the
    multi-pod (2, 16, 16) meshes, every PartitionSpec that
    ``input_specs`` gives for the four input shapes (``train_setup``'s
    state, batch, seed and metrics; ``prefill_setup``'s params, inputs
    and logits; ``decode_setup``'s params, state, tokens, step and logits
    at ``decode_32k`` and ``long_500k``) equals the reference's, leaf for
    leaf by path; so do the gathered state specs and the inner-DP plan's
    state and batch specs.  The reference runs on a stand-in abstract
    mesh that carries the ``devices`` array its plan reads.  The port
    serves from per-layer lists: each per-layer leaf holds the
    reference's stacked spec less the leading layer-group dim, which the
    plan leaves unsharded.
(b) The setups' meta-device structs equal the reference's
    ``jax.eval_shape`` structs in shape and dtype, path for path, and
    hold no storage (every leaf on the meta device).
(c) Realisation under torch's ``fake`` process-group backend: at (16, 16)
    (world 256) and (2, 16, 16) (world 512), at rank 0 and at one other
    rank, every placed leaf's local shard is the block that the
    reference's spec gives that rank's mesh coordinate (shape, and offset
    read from the view's storage offset), as torch's own
    ``compute_local_shape_and_global_offset`` gives it too.

The reference's setups re-trace ``init_lm`` on every call; the tests
memoise its ``params_struct`` and ``fed_state_struct`` (pure functions
of hashable configs) for speed.
"""
import functools
import importlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from test_torch_reference import fake_mesh, reference  # noqa: F401

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps

ALL_ARCHS = sorted(ARCHS)
MESHES = {"host": (("data", "model"), (1, 1)),
          "pod": (("data", "model"), (16, 16)),
          "multi_pod": (("pod", "data", "model"), (2, 16, 16))}
SHAPES = sorted(INPUT_SHAPES)
# the other rank of each realised mesh: coordinates (2, 5) and (1, 2, 12)
OTHER_RANK = {"pod": 37, "multi_pod": 300}


@pytest.fixture(scope="module")
def jref(reference):
    """The reference's plan, setups and configs, its struct builders
    memoised, and ``mesh(key)``: a stand-in of the mesh ``MESHES[key]``."""
    from jax.sharding import AbstractMesh

    class StandInMesh(AbstractMesh):
        """An abstract mesh with the ``devices`` array the plan reads."""

        @property
        def devices(self):
            return np.empty(self.axis_sizes, dtype=object)

    mods = {"steps": "repro.launch.steps", "configs": "repro.configs",
            "sharding": "repro.distributed.sharding",
            "variants": "repro.launch.variants"}
    ns = SimpleNamespace(**{k: importlib.import_module(v)
                            for k, v in mods.items()})
    saved = {n: getattr(ns.steps, n)
             for n in ("params_struct", "fed_state_struct")}
    for name, fn in saved.items():
        setattr(ns.steps, name, functools.lru_cache(maxsize=None)(fn))
    ns.mesh = lambda key: StandInMesh(MESHES[key][1], MESHES[key][0])
    ns.setups = functools.lru_cache(maxsize=None)(
        lambda arch, key, shape: ns.steps.input_specs(
            ns.configs.get_arch(arch), ns.configs.INPUT_SHAPES[shape],
            ns.mesh(key)))
    yield ns
    for name, fn in saved.items():
        setattr(ns.steps, name, fn)


# ---------------------------------------------------------------------------
# flattening both packages' trees to {path: leaf}
def ref_items(tree) -> dict:
    """{"/a/0/b": leaf} of a reference tree, a ``NamedSharding``'s spec
    or a ``PartitionSpec`` as a tuple, a ``ShapeDtypeStruct`` as it is."""
    from jax.sharding import NamedSharding, PartitionSpec

    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (NamedSharding, PartitionSpec)))
    out = {}
    for path, leaf in leaves:
        key = "".join("/" + str(getattr(p, "key", getattr(
            p, "idx", getattr(p, "name", p)))) for p in path)
        if isinstance(leaf, NamedSharding):
            leaf = leaf.spec
        out[key] = tuple(leaf) if isinstance(leaf, PartitionSpec) else leaf
    return out


def port_items(tree, prefix="") -> dict:
    """{"/a/0/b": leaf} of a port tree (dicts, named tuples, tuples,
    lists; a ``PartitionSpec`` as a tuple)."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, sh.P):
        out[prefix] = tuple(tree)
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(port_items(getattr(tree, k), f"{prefix}/{k}"))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(port_items(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            out.update(port_items(t, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def stacked_path(path: str, what: str, unit_len: int) -> str:
    """The reference's path of a port path in the serving layout:
    ``what`` "params": ``/layers/i/...`` -> ``/unit/{i % U}/...``,
    ``/enc_unit/i/...`` -> ``/enc_unit/...``; "state": ``/layers/i/...``
    -> ``/layers/{i % U}/...``."""
    parts = path.split("/")
    if len(parts) > 2 and parts[1] == "layers":
        head = "unit" if what == "params" else "layers"
        return "/".join(["", head, str(int(parts[2]) % unit_len)]
                        + parts[3:])
    if len(parts) > 2 and parts[1] == "enc_unit":
        return "/".join(["", "enc_unit"] + parts[3:])
    return path


def is_per_layer(path: str) -> bool:
    parts = path.split("/")
    return len(parts) > 2 and parts[1] in ("layers", "enc_unit")


def to_stacked(items: dict, what: str, cfg) -> dict:
    """Port items of a serving tree ({path: spec tuple or tensor}) keyed
    and shaped as the reference's stacked tree: a per-layer spec gains
    the unsharded leading dim, a per-layer struct the layer-group dim.
    Every layer that maps to one stacked leaf must agree."""
    from repro_torch.models.transformer import factor_pattern

    unit, n_groups = factor_pattern(cfg.pattern())
    out = {}
    for path, leaf in items.items():
        key = stacked_path(path, what, len(unit))
        if is_per_layer(path):
            n = cfg.n_enc_layers if path.startswith("/enc_unit") \
                else n_groups
            leaf = ((None,) + leaf if isinstance(leaf, tuple)
                    else ((n,) + tuple(leaf.shape), leaf.dtype))
        elif not isinstance(leaf, tuple):
            leaf = (tuple(leaf.shape), leaf.dtype)
        assert out.setdefault(key, leaf) == leaf, (path, leaf, out[key])
    return out


# per setup kind: what each argument and output is ("params", "state" or
# "plain"), by position
IN_KINDS = {"train": ("plain", "plain", "plain"),
            "prefill": ("params", "plain"),
            "decode": ("params", "state", "plain", "plain")}
OUT_KINDS = {"train": ("plain", "plain"), "prefill": ("plain",),
             "decode": ("plain", "state")}


def _port_vs_ref_specs(port, ref, kinds, cfg, where):
    if len(kinds) == 1:
        port, ref = (port,), (ref,)
    assert len(port) == len(ref) == len(kinds), where
    for i, (p, r, kind) in enumerate(zip(port, ref, kinds)):
        got = port_items(p)
        if kind != "plain":
            got = to_stacked(got, kind, cfg)
        assert got == ref_items(r), f"{where}: argument {i}"


def _struct_dtype(x) -> str:
    return str(x).split(".")[-1]


def _port_vs_ref_structs(port, ref, kinds, cfg, where):
    for i, (p, r, kind) in enumerate(zip(port, ref, kinds)):
        items = port_items(p)
        for path, leaf in items.items():
            assert leaf.is_meta, f"{where}: {path} holds storage"
        if kind == "plain":
            got = {k: (tuple(v.shape), v.dtype) for k, v in items.items()}
        else:
            got = to_stacked(items, kind, cfg)
        got = {k: (s, _struct_dtype(d)) for k, (s, d) in got.items()}
        want = {k: (tuple(v.shape), _struct_dtype(v.dtype))
                for k, v in ref_items(r).items()}
        assert got == want, f"{where}: argument {i}"


# ---------------------------------------------------------------------------
# (a) + (b): specs and structs of every setup, every mesh
@pytest.mark.parametrize("key", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_setups_match_the_reference(jref, arch, key):
    cfg = get_arch(arch)
    names, sizes = MESHES[key]
    mesh = sh.MeshShape(names, sizes)
    for name in SHAPES:
        shape = INPUT_SHAPES[name]
        _, args, in_specs, out_specs = steps.input_specs(cfg, shape, mesh)
        _, jargs, jin, jout = jref.setups(arch, key, name)
        where = f"{arch} {key} {name}"
        _port_vs_ref_specs(in_specs, jin, IN_KINDS[shape.kind], cfg, where)
        _port_vs_ref_specs(out_specs, jout, OUT_KINDS[shape.kind], cfg,
                           where + " out")
        _port_vs_ref_structs(args, jargs, IN_KINDS[shape.kind], cfg, where)


@pytest.mark.parametrize("key", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_plan_variants_match_the_reference(jref, arch, key):
    """The gathered (S, ...) state specs, ``param_spec_tree`` with the
    client dim on the fed axis and replicated, and the inner-DP plan's
    state and batch specs, on the train setup's structs."""
    cfg = get_arch(arch)
    jcfg = jref.configs.get_arch(arch)
    names, sizes = MESHES[key]
    mesh = sh.MeshShape(names, sizes)
    _, (state, batch, _), _, _ = steps.input_specs(
        cfg, INPUT_SHAPES["train_4k"], mesh)
    _, (jstate, jbatch, _), _, _ = jref.setups(arch, key, "train_4k")
    for inner_dp in (False, True):
        plan = sh.make_plan(cfg, mesh, inner_dp=inner_dp)
        jplan = jref.sharding.make_plan(jcfg, jref.mesh(key),
                                        inner_dp=inner_dp)
        assert (plan.fed_axis, plan.n_clients, plan.fsdp, plan.inner_dp) \
            == (jplan.fed_axis, jplan.n_clients, jplan.fsdp, jplan.inner_dp)
        where = f"{arch} {key} inner_dp={inner_dp}"
        pairs = [(plan.fed_state_specs(state, gathered=g),
                  jplan.fed_state_specs(jstate, gathered=g))
                 for g in (False, True)]
        pairs += [(plan.param_spec_tree(state.W, client_dim=True,
                                        client_axis=ax),
                   jplan.param_spec_tree(jstate.W, client_dim=True,
                                         client_axis=ax))
                  for ax in ("__fed__", None)]
        pairs.append((plan.batch_spec_tree(batch),
                      jplan.batch_spec_tree(jbatch)))
        for i, (got, want) in enumerate(pairs):
            assert port_items(got) == ref_items(want), f"{where}: {i}"


def test_structs_match_the_reference_builders(jref):
    """``params_struct``, ``fed_state_struct`` (C = 2) and the meta
    decode state in the stacked layout (``stacked_decode_state``) against
    the reference's own builders, for every architecture."""
    for arch in ALL_ARCHS:
        cfg, jcfg = get_arch(arch), jref.configs.get_arch(arch)
        fed = steps.fed_config_for(cfg, 2)
        pairs = [
            (steps.params_struct(cfg), jref.steps.params_struct(jcfg)),
            (steps.fed_state_struct(cfg, fed)._asdict(),
             jref.steps.fed_state_struct(
                 jcfg, jref.steps.fed_config_for(jcfg, 2))._asdict())]
        shape = INPUT_SHAPES["long_500k"]
        window = steps.decode_window(cfg, shape)
        jtr = importlib.import_module("repro.models.transformer")
        from repro_torch.models import transformer as tr

        pairs.append((
            steps.stacked_decode_state(tr.init_decode_state(
                cfg, 3, 1024, torch.bfloat16, window=window, device="meta"),
                cfg),
            jax.eval_shape(lambda: jtr.init_decode_state(
                jcfg, 3, 1024, jax.numpy.bfloat16, window=window))))
        for i, (got, want) in enumerate(pairs):
            _port_vs_ref_structs([got], [want], ["plain"], cfg,
                                 f"{arch} {i}")


# ---------------------------------------------------------------------------
# (c) realisation under the fake backend
def _expected_block(shape, spec, names, sizes, coord):
    """(local shape, global offset) of the block that ``spec`` (the
    reference's semantics: a tuple entry's first axis is the major) gives
    the mesh coordinate ``coord``."""
    local, offset = [], []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        k, idx = 1, 0
        for a in axes:
            m = names.index(a)
            idx, k = idx * sizes[m] + coord[m], k * sizes[m]
        local.append(n // k)
        offset.append(idx * (n // k))
    return tuple(local), tuple(offset)


@pytest.mark.parametrize("other", [False, True])
@pytest.mark.parametrize("key", ["pod", "multi_pod"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_placements_realise_the_reference_blocks(jref, arch, key, other):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    cfg = get_arch(arch)
    names, sizes = MESHES[key]
    rank = OTHER_RANK[key] if other else 0
    n_leaves = 0
    with fake_mesh(sizes, names, rank) as mesh:
        coord = tuple(mesh.get_coordinate())
        assert coord == tuple(np.unravel_index(rank, sizes))
        for name in SHAPES:
            shape = INPUT_SHAPES[name]
            kinds = IN_KINDS[shape.kind]
            _, args, in_specs, _ = steps.input_specs(cfg, shape, mesh)
            _, _, jin, _ = jref.setups(arch, key, name)
            for i, (arg, specs, kind) in enumerate(zip(args, in_specs,
                                                       kinds)):
                placed = port_items(sh.place_tree(arg, specs, mesh))
                want = ref_items(jin[i])
                for path, leaf in port_items(arg).items():
                    dt = placed[path]
                    if kind == "plain":
                        spec = want[path]
                    else:
                        spec = want[stacked_path(path, kind,
                                                 _unit_len(cfg))]
                        if is_per_layer(path):
                            assert spec[0] is None, (path, spec)
                            spec = spec[1:]
                    loc, off = _expected_block(tuple(leaf.shape), spec,
                                               names, sizes, coord)
                    local = dt.to_local()
                    where = f"{arch} {key} rank {rank} {name} {path}"
                    assert isinstance(dt, DTensor), where
                    assert tuple(dt.shape) == tuple(leaf.shape), where
                    assert tuple(local.shape) == loc, where
                    assert local.storage_offset() == leaf.storage_offset() \
                        + sum(o * s for o, s in zip(off, leaf.stride())), where
                    assert compute_local_shape_and_global_offset(
                        leaf.shape, mesh, dt.placements) == (loc, off), where
                    n_leaves += 1
    assert n_leaves > 0


def _unit_len(cfg) -> int:
    from repro_torch.models.transformer import factor_pattern

    return len(factor_pattern(cfg.pattern())[0])
