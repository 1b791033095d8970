"""Federated LM training over ranks on the CPU: ``launch.steps.
make_train_step`` through ``train_setup`` on a real mesh (the smoke
SmolLM-360M, C = 2 clients of 2 sequences of 32 tokens, 3 rounds), with
the clients over 2 ``"data"`` ranks and, under ``inner_dp``, one client's
batch over 2 ``"model"`` ranks; and the dry-run of the reference's
production meshes, (16, 16) and (2, 16, 16), whose collective bytes are
counted on meta.

The runs start from the reference's initial state with the LDP noise on
but below rounding (``privacy_budget_a`` = 1e18, as
``test_torch_lm_train.test_make_train_step_matches_reference``), all
clients active.  Each is held to the one-rank run and to the
reference's by ``test_torch_lm_train._compare``: its tolerance (rtol
2e-5, atol 1e-6) and its sign-tie allowance (traps C and AC, at most 8
tied coordinates, each moving by 2 psi alpha a round since its tie), no
wider.  Under ``inner_dp`` the batch's loss is the mean of the two ranks'
halves, a regrouped sum, so its gradients differ from one rank's by
roundings, which a tie can turn into a sign.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from dp_ranks import run_ranks, state_arrays
from test_torch_lm_train import (B, C, FED_KNOBS, ROUNDS, S, _batches,
                                 _cfgs, _compare, _port_batch, _ref_lm_state,
                                 jref)  # noqa: F401  (fixture)
from test_torch_reference import (  # noqa: F401  (fixture)
    one_thread, ref_state_arrays, reference)

from repro_torch.core.fed_state import fed_state_from_numpy
from repro_torch.launch import dryrun, steps
from repro_torch.tree import tree_leaves

ARCH = "smollm-360m"
KNOBS = dict(FED_KNOBS, privacy_budget_a=1e18, active_frac=1.0)


@pytest.fixture(scope="module")
def runs(reference, jref, tmp_path_factory):
    """The reference's, one rank's, two data ranks' and two model ranks'
    runs from one initial state."""
    r = reference
    jcfg, cfg = _cfgs(jref, ARCH)
    jsteps = importlib.import_module("repro.launch.steps")
    fed_j = dataclasses.replace(jsteps.fed_config_for(jcfg, C), **KNOBS)
    fed = dataclasses.replace(steps.fed_config_for(cfg, C), **KNOBS)
    batches = _batches(cfg, ROUNDS, S)
    state = _ref_lm_state(r, jcfg, fed_j)
    init = ref_state_arrays(state)
    jstep = jax.jit(jsteps.make_train_step(jcfg, fed_j))
    ref = ([], [])
    for t in range(ROUNDS):
        state, m = jstep(state, {k: jnp.asarray(v)
                                 for k, v in batches[t].items()},
                         jnp.asarray(t))
        ref[0].append(ref_state_arrays(state))
        ref[1].append({k: np.asarray(v) for k, v in m.items()})
    step = steps.make_train_step(cfg, fed)
    pstate = fed_state_from_numpy(init, device="cpu")
    one = ([], [])
    with one_thread():
        for t in range(ROUNDS):
            pstate, m = step(pstate, _port_batch(batches[t]), t)
            one[0].append(state_arrays(pstate))
            one[1].append({k: v.numpy() for k, v in m.items()})
    tmp = tmp_path_factory.mktemp("lm")
    payload = dict(arch=ARCH, C=C, B=B, S=S, knobs=KNOBS, init=init,
                   batches=batches)
    data = run_ranks((2, 1), "dp_ranks:lm_job",
                     dict(payload, inner_dp=False), tmp)
    model = run_ranks((1, 2), "dp_ranks:lm_job",
                      dict(payload, inner_dp=True), tmp)
    return dict(init=init, fed=fed, ref=ref, one=one, data=data,
                model=model)


@pytest.mark.parametrize("mesh", ["data", "model"])
def test_lm_step_over_ranks_matches_one_rank_and_reference(runs, mesh):
    init, fed = runs["init"], runs["fed"]
    for rank, out in enumerate(runs[mesh]):
        _compare(init, out["states"], out["metrics"], *runs["one"], fed)
        _compare(init, out["states"], out["metrics"], *runs["ref"], fed)
        # the split consensus: one partial and one finish a round over the
        # data ranks; at one data rank the fused kernel (no split call)
        want = (1, 1) if mesh == "data" else (0, 0)
        assert out["calls"] == [want] * ROUNDS, (rank, out["calls"])


def test_train_setup_gives_the_ranks_local_structs(runs, jref):
    """On a real mesh the structs are the rank's: one client a data rank;
    under inner_dp both clients, one of the two sequences each."""
    _, cfg = _cfgs(jref, ARCH)
    n_unit = len(tree_leaves(steps.params_struct(cfg)))
    data = runs["data"][0]["shapes"]
    model = runs["model"][0]["shapes"]
    assert len(data["state"]) == len(model["state"]) == n_unit
    assert all(s[0] == 1 for s in data["state"])
    assert all(s[0] == C for s in model["state"])
    assert data["batch"]["tokens"] == (1, B, S)
    assert model["batch"]["tokens"] == (C, B // 2, S)


def _hand_count(cfg):
    """The exchanges of a rank's inner_dp round on a production mesh, by
    hand: over "model" every gradient leaf (f32, the tree's P elements)
    and the rank's loss (its one client); over "data" the metrics' 7
    sums, the dual sums (P elements), the int8 wire's int32 sign sums
    (each leaf padded to 4 elements) and the consensus gap."""
    leaves = tree_leaves(steps.params_struct(cfg))
    P = sum(l.numel() for l in leaves)
    padded = sum(-(-l.numel() // 4) * 4 for l in leaves)
    return {"model": 4 * P + 4, "data": 4 * 7 + 4 * P + 4 * padded + 4}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dryrun_production_mesh_counts_its_collectives(jref, multi_pod):
    """SmolLM-360M (smoke) x train_4k under inner_dp+signs8, as rank 0 of
    256 / 512 ranks on meta: the rank's local shapes, every exchange
    counted, the collective term from the link model (a 16-wide "model"
    group spans two nodes of 8: InfiniBand), above 0."""
    from repro_torch.roofline import kernel_cost as kc

    _, cfg = _cfgs(jref, ARCH)
    row = dryrun.run_one(ARCH, "train_4k", multi_pod, out_dir="",
                         verbose=False, variant="inner_dp+signs8",
                         smoke=True)
    assert row["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert row["chips"] == (512 if multi_pod else 256)
    want = _hand_count(cfg)
    assert row["collectives"] == {k: float(v) for k, v in want.items()}
    assert row["collective_bytes"] == sum(want.values())
    data_size = 32 if multi_pod else 16
    t = (kc.collective_s("all_reduce", want["model"] - 4, 16, 1)
         + kc.collective_s("all_reduce", 4, 16, 1))
    assert kc.span_nodes(16, 1) == 2 and kc.span_nodes(data_size, 16) == \
        data_size
    assert row["t_collective_s"] > t > 0
    assert row["kernels"]["sign_sum"]["launches"] == 1
    assert row["kernels"]["sign_finish"]["launches"] == 1


# the rows the production meshes still refuse: SmolLM's training round
# under the default plan (step 3c), a mode-B prefill and a mode-B decode
# (step 3d: FSDP over "data"); the mode-A families' serving rows run
# (tests/test_torch_tensor_parallel*.py)
REFUSED = {"train_4k": ARCH, "prefill_32k": "llava-next-mistral-7b",
           "decode_32k": "phi3-medium-14b"}


@pytest.mark.parametrize("variant,shape", [("", "train_4k"),
                                           ("inner_dp", "prefill_32k"),
                                           ("", "decode_32k")])
def test_dryrun_other_rows_on_production_meshes_raise(variant, shape):
    for multi_pod in (False, True):
        with pytest.raises(NotImplementedError, match="7\\(b\\) step 3"):
            dryrun.run_one(REFUSED[shape], shape, multi_pod, out_dir="",
                           verbose=False, variant=variant, smoke=True)


def test_link_model():
    """NVLink inside a node of 8, InfiniBand across; a ring all-reduce
    moves 2 (n - 1) / n of the bytes."""
    from repro_torch.roofline import kernel_cost as kc

    assert kc.span_nodes(8, 1) == 1 and kc.span_nodes(2, 1) == 1
    assert kc.link_bytes_per_s(8, 1) == kc.NVLINK_BYTES_PER_S
    assert kc.link_bytes_per_s(16, 16) == kc.IB_BYTES_PER_S == 50e9
    assert kc.collective_s("all_reduce", 1e9, 4, 1) == \
        pytest.approx(1.5e9 / 450e9)
    assert kc.collective_s("all_reduce", 1e9, 16, 1) == \
        pytest.approx(2 * 15 / 16 * 1e9 / 50e9)
    with pytest.raises(ValueError, match="unknown collective"):
        kc.collective_s("broadcast", 1e9, 16, 1)
    assert kc.collective_s("all_reduce", 1e9, 1, 1) == 0.0


def test_mesh_refuses_nccl_on_the_cpu_and_a_second_group():
    """make_mesh names its backend: nccl off the GPU raises before any
    group is made; one process holds one group (trap AK)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, registered_host_mesh

    with pytest.raises(ValueError, match="nccl needs CUDA"):
        make_mesh((2, 1), "cpu", "nccl", rank=0, world_size=2,
                  store=dist.HashStore())
    assert not dist.is_initialized()
    with registered_host_mesh("cpu"):
        with pytest.raises(RuntimeError, match="already initialised"):
            make_mesh((1, 1), "cpu", "gloo", rank=0, world_size=1,
                      store=dist.HashStore())
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2), "cpu", "gloo", rank=0, world_size=2,
                  store=dist.HashStore())



def test_rank_device_gives_each_rank_its_card_whatever_the_backend(
        monkeypatch):
    """Under torchrun a rank without ``--device`` computes on
    ``cuda:LOCAL_RANK`` when the host has a card for each local rank (the
    backend plays no part); with fewer cards than ranks they share the
    default card; a named device is kept."""
    import torch

    from repro_torch.launch import mesh as mesh_lib

    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert mesh_lib.rank_device(None) == "cuda:3"
    assert mesh_lib.rank_device("cuda") == "cuda:3"
    assert mesh_lib.rank_device("cpu") == "cpu"
    assert mesh_lib.rank_device("cuda:1") == "cuda:1"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh_lib.rank_device(None) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert mesh_lib.rank_device(None) is None
