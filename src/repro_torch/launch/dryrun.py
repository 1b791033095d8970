"""Dry-run of every step on ``meta`` tensors (the port of the JAX
package's ``launch/dryrun.py``).

For an (architecture x input shape), take the step and its meta structs
from ``launch.steps.input_specs`` on the 1 x 1 host mesh, run the step on
those structs under ``roofline.cost.CostCounter`` (nothing is allocated
and no kernel is launched: each kernel wrapper adds its work), and persist
the roofline row as the reference does, to
``{out}/{arch}__{shape}__1x1.json``, with besides the reference's keys
``fits`` (the peak bytes against one card's 80 GB), ``flops_by_class``
and the hand-written kernels' launches and work.  A training row's C is
the plan's federated axis (1 on the host mesh), or ``run_one``'s
``n_clients`` when given, the global batch split among the clients.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k [--variant inner_dp] [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke

The step runs eagerly, so its scalars are Python numbers: the round's seed
0 and, for a decode step, the cache's last position (``seq_len - 1``,
every cache slot valid).  A row the card would refuse (B4's backward at a
head dim other than 64, B5 under autograd) raises as it would there; the
sweep reports it in its failure list and exits 1.  The dry-run touches no
device, so its host mesh is the CPU's (gloo), whatever machine runs it.
``--variant`` applies the whole variant, its ``fed_patch`` and
``inner_dp`` too.

The reference's production meshes, (16, 16) and (2, 16, 16)
(``--multi-pod single`` / ``multi``), run the training rows of mode-A
configs under an ``inner_dp`` variant: the step runs as rank 0 of a mesh
of 256 or 512 ranks over torch's ``fake`` process-group backend, at the
rank's local shapes (``steps.train_setup(rank_local=True)``: its block
of the clients, its rows of each client's batch), and its exchanges
(``distributed.collectives``) are counted, not sent: the roofline's
collective term comes from their bytes and the link model of
``roofline.kernel_cost`` (NVLink within a node of 8, InfiniBand between).
The row is written as ``{arch}__{shape}__16x16.json`` or
``__2x16x16.json``.  Their serving rows (``prefill_32k``, ``decode_32k``)
of every mode-A family (SmolLM-360M, Gemma-7B, Hymba-1.5B,
SeamlessM4T-medium, Granite-MoE-3B-a800m, OLMoE-1B-7B, xLSTM-1.3B) run
the same way under the default plan, tensor-parallel over ``"model"``
(``distributed/tensor_parallel.py``; ``steps.prefill_setup`` /
``decode_setup(rank_local=True)``: rank 0's rows and blocks, at
``decode_32k`` on (16, 16) 8 rows x 2,048 cache positions), with a
``"model"`` collective term from the counted bytes.  What still raises
``NotImplementedError``, naming its ROADMAP item (:func:`check_mesh`):
training without ``inner_dp`` (7(b) step 3c), mode B (step 3d: FSDP over
a real ``"data"`` axis), ``long_500k``'s decode (B = 1: the plan puts
``"model"`` on head_dim, step 3d).  xLSTM's ``prefill_32k`` row runs an
eager sLSTM loop of one step a position (150.8 s on meta at 4,096
positions), so it is run with ``--smoke`` or a ``cut`` of its length.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch, reduce_for_smoke
from repro_torch.launch import steps as steps_lib
from repro_torch.roofline import kernel_cost
from repro_torch.roofline.analysis import analyze, model_flops_for
from repro_torch.roofline.cost import CostCounter

MESH_NAME = "1x1"
MULTI_POD = {"host": None, "single": False, "multi": True}
# the reference's production meshes (launch/mesh.make_production_mesh)
PRODUCTION = {False: ("16x16", ("data", "model"), (16, 16)),
              True: ("2x16x16", ("pod", "data", "model"), (2, 16, 16))}


def check_mesh(multi_pod: Optional[bool], kind: str = "train",
               inner_dp: bool = False, fed_mode: str = "A",
               batch: int = 0) -> None:
    """The rows the port runs: every row on the host mesh (``multi_pod``
    None); on the production meshes the training rows of mode-A configs
    under ``inner_dp`` and the serving rows of mode-A configs (a decode
    row of ``batch`` > 1).  Any other raises ``NotImplementedError``
    naming its ROADMAP Queue A 7(b) step: 3c (training under the default
    plan), 3d (mode B; ``long_500k``'s head_dim split)."""
    from repro_torch.distributed import tensor_parallel as tp

    if multi_pod is None:
        return
    row = (f"a {kind} row (inner_dp={inner_dp}, mode {fed_mode}) on the "
           f"{PRODUCTION[multi_pod][0]} mesh")
    if fed_mode != "A":
        raise NotImplementedError(f"{row}: {tp.STEP3D}")
    if kind == "train":
        if not inner_dp:
            raise NotImplementedError(f"{row}: {tp.STEP3C}")
        return
    if kind == "decode" and batch == 1:
        raise NotImplementedError(f"{row} of one sequence: {tp.STEP3D}")


@contextlib.contextmanager
def fake_mesh(sizes, names):
    """A ``DeviceMesh`` of ``sizes`` named ``names`` with this process as
    its rank 0, over torch's ``fake`` process-group backend (no peers,
    nothing sent); the group is destroyed after the block."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(sizes))
    try:
        yield init_device_mesh("cpu", tuple(sizes),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool):
    """The (16, 16) or (2, 16, 16) mesh as :func:`fake_mesh`."""
    _, names, sizes = PRODUCTION[multi_pod]
    return fake_mesh(sizes, names)


def smoke_case(cfg, shape, multi_pod: Optional[bool] = None):
    """``launch.train --smoke``'s cut: the smoke config, 64-position
    sequences, a global batch of 4 (on a production mesh the shape's own,
    which its clients and ``"model"`` ranks split)."""
    batch = 4 if multi_pod is None else shape.global_batch
    return reduce_for_smoke(cfg), dataclasses.replace(shape, seq_len=64,
                                                      global_batch=batch)


def concrete_scalars(args, shape):
    """The step's arguments with its meta scalars as Python numbers: the
    round's seed 0, a decode step's position ``seq_len - 1``."""
    args = list(args)
    if shape.kind == "train":
        args[2] = 0
    elif shape.kind == "decode":
        args[3] = shape.seq_len - 1
    return tuple(args)


def run_one(arch_name: str, shape_name: str,
            multi_pod: Optional[bool] = None,
            out_dir: str = "results/dryrun", verbose: bool = True,
            setup_override=None, variant: str = "",
            smoke: bool = False, cut: Optional[dict] = None,
            n_clients: Optional[int] = None,
            n_layers: Optional[int] = None) -> dict:
    """Dry-run one (arch x shape) on the host mesh and return its row
    (also written under ``out_dir`` unless it is empty).  ``multi_pod``
    None is the host mesh; False / True the reference's (16, 16) and
    (2, 16, 16) meshes, as rank 0 (:func:`check_mesh` says which rows
    run there).  ``setup_override(cfg, shape, mesh)``
    replaces ``steps.input_specs``; ``smoke`` takes :func:`smoke_case`;
    ``cut`` replaces fields of the input shape (``seq_len``,
    ``global_batch``) and is recorded in the row; ``n_clients`` is a
    training round's C (recorded as ``n_clients``); ``n_layers`` cuts the
    config's depth, its width unchanged (recorded as ``n_layers``, None
    for the config's own).  The per-device
    caches are made on meta before counting
    (``steps.warm_device_caches``), as a measurement on the card makes
    them before its baseline."""
    from repro_torch.launch.mesh import registered_host_mesh

    cfg = get_arch(arch_name)
    shape = INPUT_SHAPES[shape_name]
    if smoke:
        cfg, shape = smoke_case(cfg, shape, multi_pod)
    if cut:
        shape = dataclasses.replace(shape, **cut)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    setup_kwargs, fed_base = {}, None
    if variant:
        from repro_torch.launch.variants import get_variant
        cfg, fed_base, setup_kwargs = get_variant(variant).apply(cfg)
        arch_name = f"{arch_name}+{variant}"
    check_mesh(multi_pod, shape.kind, setup_kwargs.get("inner_dp", False),
               cfg.fed_mode, shape.global_batch)
    mesh_name = MESH_NAME if multi_pod is None else PRODUCTION[multi_pod][0]

    t0 = time.time()
    if multi_pod is None:
        mesh_cm = registered_host_mesh("cpu")
    else:
        mesh_cm = production_mesh(multi_pod)
        setup_kwargs = dict(setup_kwargs, rank_local=True)
    with mesh_cm as mesh:
        chips = int(mesh.size())
        if setup_override:
            step, args, _, _ = setup_override(cfg, shape, mesh)
        else:
            step, args, _, _ = steps_lib.input_specs(
                cfg, shape, mesh, base_fed=fed_base, n_clients=n_clients,
                **setup_kwargs)
        args = concrete_scalars(args, shape)
        steps_lib.warm_device_caches(cfg, "meta")
        t_setup = time.time() - t0
        with CostCounter(args) as counter:
            out = step(*args)
        t_run = time.time() - t0 - t_setup
    report = analyze(counter, out, arch=arch_name, shape=shape_name,
                     mesh_name=mesh_name, chips=chips,
                     model_flops=model_flops_for(cfg, shape))
    del out
    row = report.row()
    row.update({
        "lower_s": round(t_setup, 1), "compile_s": round(t_run, 1),
        "memory_analysis": {
            "argument_size_in_bytes": report.argument_bytes,
            "output_size_in_bytes": report.output_bytes,
            "temp_size_in_bytes": report.temp_bytes,
        },
        "fed_mode": cfg.fed_mode,
        "kind": shape.kind,
        "fits": report.bytes_per_device <= kernel_cost.HBM_BYTES,
        "flops_by_class": report.flops_by_class,
        "dot_flops": report.dot_flops,
        "kernel_flops": report.kernel_flops,
        "kernels": {k: dataclasses.asdict(v)
                    for k, v in counter.kernels.items()},
        "step_time_s": report.step_time,
        "n_ops": counter.n_ops,
        "cut": cut or {},
        "n_clients": n_clients,
        "n_layers": n_layers,
    })
    if verbose:
        print(f"[dryrun] {arch_name} x {shape_name} on {mesh_name}: "
              f"{counter.n_ops} ops on meta in {t_run:.1f}s")
        print(f"  memory: args {report.argument_bytes:.3e}B outputs "
              f"{report.output_bytes:.3e}B temp {report.temp_bytes:.3e}B "
              f"-> {report.bytes_per_device / 1e9:.2f} GB "
              f"({'fits' if row['fits'] else 'does NOT fit'} 80 GB)")
        print(f"  flops={report.flops:.3e} (dot {report.dot_flops:.3e}, "
              f"kernels {report.kernel_flops:.3e}; by class "
              + ", ".join(f"{c} {f:.3e}"
                          for c, f in report.flops_by_class.items())
              + f")  hbm={report.hbm_bytes:.3e}B")
        print(f"  terms: compute {report.t_compute*1e3:.2f}ms | memory "
              f"{report.t_memory*1e3:.2f}ms | collective "
              f"{report.t_collective*1e3:.2f}ms -> dominant "
              f"{report.dominant}  useful_ratio="
              f"{report.useful_flops_ratio:.3f}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch_name}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(row, f, indent=1)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--all", action="store_true",
                    help="every arch x every shape (the defaults)")
    ap.add_argument("--multi-pod", default="host", choices=list(MULTI_POD),
                    help="host: the 1 x 1 host mesh; single / multi: the "
                         "reference's (16, 16) / (2, 16, 16) meshes, as "
                         "rank 0 (training rows under inner_dp, the "
                         "mode-A families' serving rows)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--variant", default="",
                    help="named hillclimb variant (launch/variants.py)")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke config at 4 x 64 positions")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.all or args.arch == "all" else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.all or args.shape == "all"
              else [args.shape])
    multi_pod = MULTI_POD[args.multi_pod]
    if multi_pod is not None:
        # a production mesh with no row the port runs there refuses at once
        inner_dp = False
        if args.variant:
            from repro_torch.launch.variants import get_variant
            inner_dp = get_variant(args.variant).inner_dp
        refusals = []
        for a in archs:
            for s in shapes:
                try:
                    check_mesh(multi_pod, INPUT_SHAPES[s].kind, inner_dp,
                               get_arch(a).fed_mode,
                               INPUT_SHAPES[s].global_batch)
                except NotImplementedError as e:
                    refusals.append(e)
        if len(refusals) == len(archs) * len(shapes):
            raise refusals[0]

    failures = []
    for a in archs:
        for s in shapes:
            try:
                run_one(a, s, multi_pod, out_dir=args.out,
                        variant=args.variant, smoke=args.smoke)
            except Exception as e:  # noqa: BLE001  (listed, exit code 1)
                failures.append((a, s, args.multi_pod, repr(e)))
                print(f"[dryrun] FAIL {a} x {s} mesh={args.multi_pod}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nAll dry-runs ran.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
