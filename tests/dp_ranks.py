"""Run a job as every rank of a gloo group on the CPU, for the
data-parallel tests (``tests/test_torch_data_parallel*.py``).

:func:`run_ranks` starts one process per rank (``python
tests/dp_ranks.py JOB STORE RANK WORLD``), each joining an R x M
``("data", "model")`` mesh over gloo from a ``FileStore`` under the
test's ``tmp_path`` (``launch/mesh.make_mesh``), calling
``JOB``'s function with the mesh and its payload on one torch thread, and
pickling what it returns.  The jobs below import torch and the port,
never JAX: the tests compare their results with one rank and with the
reference in the main process.
"""
from __future__ import annotations

import functools
import importlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(shape, job: str, payload, tmp_path, timeout: float = 300.0):
    """``job`` (``"module:function"``) as every rank of an ``shape`` =
    (R, M) mesh; returns the ranks' results in rank order.  A rank that
    fails (or outlasts ``timeout``) fails the call, with its stderr, and
    the others are killed."""
    world = shape[0] * shape[1]
    tag = f"{job.split(':')[1]}-{shape[0]}x{shape[1]}"
    spec = Path(tmp_path) / f"{tag}.job"
    spec.write_bytes(pickle.dumps((job, payload, tuple(shape))))
    store = Path(tmp_path) / f"{tag}.store"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(spec), str(store), str(r),
         str(world)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errs.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        raise AssertionError("\n".join(errs))
    return [pickle.loads(Path(f"{spec}.{r}").read_bytes())
            for r in range(world)]


def _main(spec: str, store: str, rank: int, world: int) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    job, payload, shape = pickle.loads(Path(spec).read_bytes())
    mod, fn = job.split(":")
    run = getattr(importlib.import_module(mod), fn)
    mesh = make_mesh(shape, "cpu", "gloo", rank=rank, world_size=world,
                     store=dist.FileStore(store, world))
    try:
        out = run(mesh, payload)
    finally:
        dist.destroy_process_group()
    assert "jax" not in sys.modules, "a rank imported JAX"
    Path(f"{spec}.{rank}").write_bytes(pickle.dumps(out))


# ---------------------------------------------------------------------------
# shared by the jobs and the one-rank runs of the tests
def state_arrays(state) -> dict:
    """A ``FedState`` as a dict of numpy trees (copies)."""
    from repro_torch.tree import tree_map

    return {k: None if v is None else tree_map(
        lambda t: t.detach().cpu().numpy().copy(), v)
        for k, v in state._asdict().items()}


class LaunchCount:
    """Counts the split consensus's calls (partial and finish, per call
    one launch per dtype group on the card) while it is entered."""

    def __init__(self):
        self.sums = self.finishes = 0

    def __enter__(self):
        from repro_torch.kernels import sign_agg as sa

        self._orig = (sa.sign_sum_group, sa.sign_sum_int8_group,
                      sa.sign_finish_group)

        def count(fn, attr):
            def wrapped(*a, **k):
                setattr(self, attr, getattr(self, attr) + 1)
                return fn(*a, **k)
            return wrapped

        sa.sign_sum_group = count(self._orig[0], "sums")
        sa.sign_sum_int8_group = count(self._orig[1], "sums")
        sa.sign_finish_group = count(self._orig[2], "finishes")
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import sign_agg as sa

        (sa.sign_sum_group, sa.sign_sum_int8_group,
         sa.sign_finish_group) = self._orig


def forecaster_round(case: dict, ranks, sparse: bool):
    """The round function of a forecaster case (``case``: knobs, C, the
    input noise sigma, ``hidden``/``horizon``), partial'd as the tests
    call it."""
    from repro_torch.configs import FedConfig, ForecastConfig
    from repro_torch.core import bafdp
    from repro_torch.core.byzantine import byz_mask
    from repro_torch.core.privacy import gaussian_c3, perturb_inputs
    from repro_torch.models.forecasting import mse_loss

    cfg = ForecastConfig(hidden=case["hidden"], horizon=case["horizon"])
    knobs = dict(case["knobs"])
    if sparse:
        knobs["consensus_scope"] = "active"
    fed = FedConfig(n_clients=case["C"], **knobs)
    c3 = gaussian_c3(cfg.d_x + cfg.d_y, fed.dp_delta, 0.05)

    def local_loss(W, batch, gen, eps):
        x, y = batch
        return mse_loss(W, perturb_inputs(gen, x, eps, case["sigma"],
                                          fed.eps_min), y, cfg)

    extra = {} if ranks is None else {"ranks": ranks}
    return functools.partial(
        bafdp.bafdp_round_sparse if sparse else bafdp.bafdp_round,
        local_loss=local_loss, fed=fed, c3=c3, n_samples=100,
        d_dim=cfg.d_x + cfg.d_y, byz_mask=byz_mask(case["C"],
                                                   fed.n_byzantine),
        **extra)


def run_forecaster(case: dict, ranks=None, sparse: bool = False):
    """``case``'s rounds from its initial state: at one rank (``ranks``
    None) the whole state, else this rank's clients
    (``shard_clients``) and their rows of each batch (under ``inner_dp``
    also of each client's batch rows).  Returns the whole state after
    each round (``unshard_clients``), the metrics and the split
    consensus's (partial, finish) calls a round."""
    from repro_torch.core.fed_state import (fed_state_from_numpy,
                                            shard_clients, unshard_clients)

    if ranks is not None and ranks.model.size > 1:
        ranks = ranks.with_batch(case["batches"][0][0].shape[1])
    step = forecaster_round(case, ranks, sparse)
    state = shard_clients(fed_state_from_numpy(case["init"], device="cpu"),
                          ranks)
    states, metrics, calls = [], [], []
    for t, batch in enumerate(case["batches"]):
        x, y = (torch.from_numpy(a) for a in batch)
        if ranks is not None:
            x, y = x[ranks.clients()], y[ranks.clients()]
            if ranks.batch is not None:
                _, start, n, _ = ranks.batch
                x, y = x[:, start:start + n], y[:, start:start + n]
        kw = dict(case["rows"][t])
        with LaunchCount() as lc:
            state, m = step(state, (x.contiguous(), y.contiguous()),
                            torch.Generator().manual_seed(100 + t), **kw)
        calls.append((lc.sums, lc.finishes))
        states.append(state_arrays(unshard_clients(state, ranks)))
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
    return states, metrics, calls


def sign_counts(z_leaves, W_leaves, ranks=None, message="f32"):
    """The round's unweighted Eq. (20) sums of ``sign(z - w_i)`` over the
    fleet: f32 (``message`` f32) or int32 (the int8 wire's), one flat
    buffer; over several ranks this rank's rows' partial sums
    all-reduced."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import sign_agg as sa

    if ranks is not None:
        W_leaves = [W[ranks.clients()] for W in W_leaves]
    if message == "int8":
        pay = [collectives.encode_sign_message(z, W).payload
               for z, W in zip(z_leaves, W_leaves)]
        sums = sa.sign_sum_int8_group(z_leaves, pay, None)
    else:
        sums = sa.sign_sum_group(z_leaves, W_leaves, None)
    if ranks is not None:
        collectives.all_reduce_sum(sums, ranks.data)
    return sums.numpy().copy()


# ---------------------------------------------------------------------------
# the jobs
def forecaster_job(mesh, payload):
    """Every forecaster case of ``payload`` (``{"cases": {name: case},
    "sparse": bool, "counts": (z, W) numpy leaves or None}``) on this
    rank; ``counts``: the all-reduced sign sums from that state, both
    wires."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.data_parallel import rank_block

    out = {}
    for name, case in payload["cases"].items():
        ranks = rank_block(mesh, case["C"])
        out[name] = run_forecaster(case, ranks, payload["sparse"])
    ranks = rank_block(mesh, mesh.size())
    got = collectives.all_reduce_sum(
        torch.full((3,), float(ranks.data.rank)), ranks.data)
    out["all_reduce_sum"] = got.tolist()
    if payload.get("counts") is not None:
        zs, Ws = payload["counts"]
        ranks = rank_block(mesh, Ws[0].shape[0])
        z_t = [torch.from_numpy(z) for z in zs]
        W_t = [torch.from_numpy(W) for W in Ws]
        out["counts"] = {m: sign_counts(z_t, W_t, ranks, m)
                         for m in ("f32", "int8")}
    return out


def lm_job(mesh, payload):
    """``launch.steps.make_train_step`` over this rank's LM clients (its
    rows of each batch under ``inner_dp``), from ``payload``'s initial
    state, through ``steps.train_setup`` on the mesh."""
    import dataclasses

    from repro_torch.configs import InputShape, get_arch, reduce_for_smoke
    from repro_torch.core.fed_state import (fed_state_from_numpy,
                                            shard_clients, unshard_clients)
    from repro_torch.distributed.data_parallel import rank_block
    from repro_torch.launch import steps

    cfg = reduce_for_smoke(get_arch(payload["arch"]))
    C, B, S = payload["C"], payload["B"], payload["S"]
    fed = dataclasses.replace(steps.fed_config_for(cfg, C),
                              **payload["knobs"])
    step, (state_sds, batch_sds, _), _, _ = steps.train_setup(
        cfg, InputShape("t", S, C * B, "train"), mesh, base_fed=fed,
        inner_dp=payload["inner_dp"], n_clients=C)
    ranks = rank_block(mesh, C)
    rows = slice(None)
    if ranks.model.size > 1:
        start, n, _ = ranks.batch_rows(B)
        rows = slice(start, start + n)
    state = shard_clients(fed_state_from_numpy(payload["init"], "cpu"),
                          ranks)
    shapes = {"state": [tuple(l.shape) for l in
                        torch.utils._pytree.tree_leaves(state_sds.W)],
              "batch": {k: tuple(v.shape) for k, v in batch_sds.items()}}
    states, metrics, calls = [], [], []
    for t, batch in enumerate(payload["batches"]):
        b = {k: torch.from_numpy(np.ascontiguousarray(
            v[ranks.clients(), rows])) for k, v in batch.items()}
        with LaunchCount() as lc:
            state, m = step(state, b, t)
        calls.append((lc.sums, lc.finishes))
        states.append(state_arrays(unshard_clients(state, ranks)))
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
    return {"states": states, "metrics": metrics, "calls": calls,
            "shapes": shapes}


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
