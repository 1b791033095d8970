#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

In order: prints the card's name and power limit; builds the Eq. (20)
consensus kernels (``src/repro_torch/kernels/csrc/sign_agg.cu``) with
nvcc for sm_90a; holds each kernel against its plain PyTorch version on
the card, bit for bit, at the main path's shapes, on the reference's TPU
test grid and at one bandwidth-bound shape; times kernel and plain
version with CUDA events; trains the BAFDP MLP_H24 traffic forecaster
(``repro_torch.train.train_bafdp``, 10 clients, full width) for 20 rounds
four times, once through each kernel, checking each run's launch count;
and runs 3 rounds on the CPU and on the card from one state and compares
them.  Any failed check raises.  The last line is the JSON result; the
line before it lists the kernels with their launches and times.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Per-shape details also go to
``build/chip_smoke.json``.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PSI, ALPHA = 0.005, 0.01
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
N_CLIENTS, ROUNDS = 10, 20
MAIN_LEAF_D = [128, 2816, 128, 16384, 64, 8192, 24, 1536]   # MLP_H24
SOURCE = "src/repro_torch/kernels/csrc/sign_agg.cu"
TPU_SRC = "src/repro/kernels/sign_agg.py"


def log(msg: str) -> None:
    print(msg, flush=True)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns; NaN positions equal whatever their payload."""
    a, b = a.float().cpu(), b.float().cpu()
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32),
                                b[~nan].view(torch.int32)))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    ok = ~(torch.isnan(a) | torch.isnan(b))
    return float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0


def call_ms(fn, reps: int = 25, inner: int = 10, warmup: int = 5) -> float:
    """Time per call as the main path pays it, host work included: the
    median over ``reps`` CUDA-event samples of ``inner`` back-to-back
    calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def sleep_cycles_per_ms() -> float:
    """Clock of ``torch.cuda._sleep``, measured with CUDA events."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, cycles_per_ms: float, reps: int = 25,
              inner: int = 10) -> float:
    """Device time per call: as :func:`call_ms`, but each sample starts
    behind a ``torch.cuda._sleep`` long enough for the host to enqueue
    all ``inner`` calls, so the launches run back to back on the card
    and the host's Python time drops out."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 0.05)))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def make_inputs(C: int, D: int, dtype: torch.dtype, seed: int,
                edge_cases: bool = True):
    """z, W, phi in ``dtype``; weights f32; the int8 sign payload.  With
    ``edge_cases``: NaN columns and exact ties (sign 0)."""
    from repro_torch.distributed import collectives

    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(D, generator=g, device="cuda")
    W = torch.randn(C, D, generator=g, device="cuda")
    phi = torch.randn(D, generator=g, device="cuda") * 0.01
    sw = torch.rand(C, generator=g, device="cuda") * 0.95 + 0.05
    if edge_cases and D >= 16:
        W[0, :5] = float("nan")
        W[C - 1, 5:9] = z[5:9]
    z, W, phi = z.to(dtype), W.to(dtype), phi.to(dtype)
    payload = collectives.encode_sign_message(z, W).payload
    return {"z": z, "W": W, "phi": phi, "sw": sw, "payload": payload}


def kernel_specs():
    """The four ways the main path reaches B1-B3: wrapper, plain version,
    bytes moved, the FedConfig knobs that select it."""
    from repro_torch.kernels import ref, sign_agg as sa

    def vec_bytes(x):
        return 3 * x["z"].numel() * x["z"].element_size()

    return [
        dict(name="sign_agg", counter="sign_agg",
             replaces=f"{TPU_SRC}:58",
             knobs=dict(sign_message="f32", staleness_decay="constant"),
             kernel=lambda x: sa.sign_agg(x["z"], x["W"], x["phi"], PSI,
                                          ALPHA),
             plain=lambda x: ref.sign_agg_ref(x["z"], x["W"], x["phi"], PSI,
                                              ALPHA),
             nbytes=lambda x: x["W"].numel() * x["W"].element_size()
             + vec_bytes(x),
             flops=lambda x: 2 * x["W"].numel()),
        dict(name="sign_agg_weighted", counter="sign_agg_weighted",
             replaces=f"{TPU_SRC}:100",
             knobs=dict(sign_message="f32", staleness_decay="poly"),
             kernel=lambda x: sa.sign_agg_weighted(
                 x["z"], x["W"], x["phi"], x["sw"], PSI, ALPHA),
             plain=lambda x: ref.sign_agg_weighted_ref(
                 x["z"], x["W"], x["phi"], x["sw"], PSI, ALPHA),
             nbytes=lambda x: x["W"].numel() * x["W"].element_size()
             + vec_bytes(x) + 4 * x["sw"].numel(),
             flops=lambda x: 3 * x["W"].numel()),
        dict(name="sign_agg_weighted_int8/weighted",
             counter="sign_agg_weighted_int8", replaces=f"{TPU_SRC}:160",
             knobs=dict(sign_message="int8", staleness_decay="poly"),
             kernel=lambda x: sa.sign_agg_weighted_int8(
                 x["z"], x["payload"], x["sw"], x["phi"], PSI, ALPHA),
             plain=lambda x: ref.sign_agg_int8_ref(
                 x["z"], x["payload"], x["sw"], x["phi"], PSI, ALPHA),
             nbytes=lambda x: x["payload"].numel() + vec_bytes(x)
             + 4 * x["sw"].numel(),
             flops=lambda x: 2 * x["payload"].numel()),
        dict(name="sign_agg_weighted_int8/unweighted",
             counter="sign_agg_weighted_int8", replaces=f"{TPU_SRC}:160",
             knobs=dict(sign_message="int8", staleness_decay="constant"),
             kernel=lambda x: sa.sign_agg_weighted_int8(
                 x["z"], x["payload"], None, x["phi"], PSI, ALPHA),
             plain=lambda x: ref.sign_agg_int8_ref(
                 x["z"], x["payload"], None, x["phi"], PSI, ALPHA),
             nbytes=lambda x: x["payload"].numel() + vec_bytes(x),
             flops=lambda x: x["payload"].numel()),
    ]


def bound_ms(spec, x):
    """The least time for this call: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    t_bytes = spec["nbytes"](x) / HBM_BYTES_PER_S * 1e3
    t_ops = spec["flops"](x) / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernels(specs, report):
    """Every kernel against its plain version on the card, bit for bit."""
    from repro_torch.kernels import ref, sign_agg as sa

    shapes = [("main", N_CLIENTS, d, torch.float32) for d in MAIN_LEAF_D]
    shapes += [("tpu_grid", c, d, dt) for d in (128, 1024, 5000, 8193)
               for c in (2, 16) for dt in (torch.float32, torch.bfloat16)]
    shapes += [("tpu_grid", 200, d, dt) for d in (600, 8193)
               for dt in (torch.float32, torch.bfloat16)]
    shapes += [("bandwidth", 64, 4_194_304, torch.float32)]
    n = 0
    grid = []
    cpm = sleep_cycles_per_ms()
    for spec in specs:
        spec["max_abs_err"] = 0.0
    for i, (tag, C, D, dt) in enumerate(shapes):
        x = make_inputs(C, D, dt, seed=i)
        for spec in specs:
            got, want = spec["kernel"](x), spec["plain"](x)
            torch.cuda.synchronize()
            if got.dtype != x["z"].dtype or got.shape != x["z"].shape:
                raise AssertionError(f"{spec['name']} {tag} C={C} D={D}: "
                                     f"{got.dtype}{tuple(got.shape)}")
            if not bits_equal(got, want):
                raise AssertionError(
                    f"{spec['name']} {tag} C={C} D={D} {dt}: kernel != "
                    f"plain version (max |err| {max_abs_err(got, want)})")
            spec["max_abs_err"] = max(spec["max_abs_err"],
                                      max_abs_err(got, want))
            n += 1
            if tag == "tpu_grid":
                grid.append(time_grid_shape(spec, x, C, D, dt, cpm))
        if tag == "tpu_grid":
            # B2 with the active-subset divisor n_total of a later slice
            got = sa.sign_agg_weighted(x["z"], x["W"], x["phi"], x["sw"],
                                       PSI, ALPHA, n_total=3 * C)
            want = ref.sign_agg_fold_ref(x["z"], x["W"], x["phi"], x["sw"],
                                         PSI, ALPHA, 3 * C)
            if not bits_equal(got, want):
                raise AssertionError(f"sign_agg_weighted n_total C={C} D={D}")
            n += 1
        del x
    # B3 past the int8 range: 200 clients on one side of z sum to 200
    x = make_inputs(200, 600, torch.float32, seed=0, edge_cases=False)
    payload = torch.ones_like(x["payload"])
    got = sa.sign_agg_weighted_int8(x["z"], payload, None, x["phi"], PSI,
                                    ALPHA)
    want = ref.sign_agg_ref(x["z"], x["z"][None].expand(200, -1) - 1000.0,
                            x["phi"], PSI, ALPHA)
    if not bits_equal(got, want):
        raise AssertionError("sign_agg_weighted_int8: C=200 sum wrapped")
    n += 1
    report["checks"] = n
    report["grid_timings"] = grid
    log(f"checks: {n} kernel calls equal their plain versions bit for bit "
        f"({len(shapes)} shapes, NaN and tie columns included)")


def time_grid_shape(spec, x, C, D, dtype, cpm):
    """Device time of kernel and plain version at one shape of the TPU
    test grid (fewer samples than the main path's).  At C=200 the plain
    version's ~1400 launches can fill the launch queue, and then its time
    includes some host time."""
    row = dict(kernel=spec["name"], C=C, D=D, dtype=str(dtype),
               kernel_ms=device_ms(lambda: spec["kernel"](x), cpm, reps=20,
                                   inner=2),
               plain_ms=device_ms(lambda: spec["plain"](x), cpm, reps=20,
                                  inner=2))
    row["bound_ms"], row["bound_by"] = bound_ms(spec, x)
    log(f"grid {spec['name']:34s} C={C:3d} D={D:5d} {dtype} "
        f"kernel_ms={row['kernel_ms']:.6f} plain_ms={row['plain_ms']:.6f} "
        f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']})")
    return row


def time_kernels(specs, report):
    """Kernel, plain version and bound at the main path's shapes (one
    round: the 8 leaves) and at the bandwidth-bound shape.  ``*_ms`` is
    device time (:func:`device_ms`); ``*_call_ms`` includes the host's
    time per call (:func:`call_ms`), what an eager round pays."""
    cpm = sleep_cycles_per_ms()
    rows = []
    for spec in specs:
        spec.update(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for tag, C, D in ([("main", N_CLIENTS, d) for d in MAIN_LEAF_D]
                          + [("bandwidth", 64, 4_194_304)]):
            x = make_inputs(C, D, torch.float32, seed=D, edge_cases=False)
            inner = 10 if tag == "main" else 2
            row = dict(kernel=spec["name"], shape=tag, C=C, D=D,
                       kernel_ms=device_ms(lambda: spec["kernel"](x), cpm,
                                           inner=inner),
                       plain_ms=device_ms(lambda: spec["plain"](x), cpm,
                                          reps=21, inner=inner),
                       kernel_call_ms=call_ms(lambda: spec["kernel"](x),
                                              inner=inner),
                       plain_call_ms=call_ms(lambda: spec["plain"](x),
                                             reps=21, inner=inner),
                       bytes=spec["nbytes"](x))
            row["bound_ms"], row["bound_by"] = bound_ms(spec, x)
            rows.append(row)
            log(f"time {spec['name']:34s} {tag:9s} C={C:3d} D={D:8d} "
                f"kernel_ms={row['kernel_ms']:.6f} "
                f"plain_ms={row['plain_ms']:.6f} "
                f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
                f"call_ms: kernel={row['kernel_call_ms']:.6f} "
                f"plain={row['plain_call_ms']:.6f}")
            if tag == "main":
                spec["ms"] += row["kernel_ms"]
                spec["plain_ms"] += row["plain_ms"]
                spec["bound_ms"] += row["bound_ms"]
                spec["bound_by"] = row["bound_by"]
            del x
    report["timings"] = rows


def train_runs(specs, report):
    """The main path: train_bafdp on the card, once through each kernel;
    each run must launch its kernel rounds x 8 leaves times and no other."""
    from repro_torch import train
    from repro_torch.configs import FedConfig
    from repro_torch.kernels import sign_agg as sa

    train.problem("milano", 24, N_CLIENTS, 0)              # data set-up
    train.train_bafdp("milano", 24, FedConfig(n_clients=N_CLIENTS),
                      rounds=2, device="cuda")             # CUDA warm-up
    runs = []
    for spec in specs:
        fed = FedConfig(n_clients=N_CLIENTS, **spec["knobs"])
        sa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, cfg, hist = train.train_bafdp(
            "milano", 24, fed, rounds=ROUNDS, seed=0,
            collect=("data_loss",), device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(sa.LAUNCHES)
        want = {k: 0 for k in counts}
        want[spec["counter"]] = ROUNDS * len(MAIN_LEAF_D)
        if counts != want:
            raise AssertionError(f"{spec['name']} run: launches {counts}, "
                                 f"expected {want}")
        spec["launches"] = counts[spec["counter"]]
        _, test, scalers = train.problem("milano", 24, N_CLIENTS, 0)
        rmse, mae = train.eval_fed_state(state, cfg, test, scalers)
        loss = np.asarray(hist["data_loss"])
        if not (np.isfinite(loss).all() and np.isfinite([rmse, mae]).all()):
            raise AssertionError(f"{spec['name']} run: non-finite "
                                 f"loss {loss} rmse {rmse} mae {mae}")
        ms = secs * 1e3 / ROUNDS
        runs.append(dict(kernel=spec["name"], knobs=spec["knobs"],
                         rounds=ROUNDS, ms_per_round=ms, launches=counts,
                         data_loss_first=float(loss[0]),
                         data_loss_last=float(loss[-1]), rmse=rmse, mae=mae))
        log(f"train {spec['name']:34s} {spec['knobs']} {ROUNDS} rounds: "
            f"ms_per_round={ms:.3f} launches={spec['launches']} "
            f"data_loss {loss[0]:.5f}->{loss[-1]:.5f} rmse={rmse:.3f} "
            f"mae={mae:.3f}")
    report["train"] = runs


def cpu_vs_cuda(report):
    """3 rounds of the f32 + poly config on the CPU and on the card from
    one state, input_sigma=0, explicit activity rows.

    The devices order matmul and reduction sums differently, a few ulp
    per round, so every element of every state leaf agrees within DRIFT
    = 2e-5 + 1e-4 |x| — except where that drift decided a discontinuity:
    a sign(w - z) or sign(z - w) at a tie, or the direction of an Adam
    step on a near-zero gradient (m / sqrt(v) is +-1 whatever the
    gradient's size).  Such an element may differ by up to what Adam can
    move a weight, 2 alpha_w per round (BOUND), and at most 1 % of a
    leaf's elements (at least one) may exceed DRIFT.  The per-round
    losses and the final RMSE / MAE agree within rtol 1e-4."""
    from repro_torch import train
    from repro_torch.configs import FedConfig
    from repro_torch.core.fed_state import fed_state_from_numpy, init_fed_state
    from repro_torch.models.forecasting import init_forecaster

    rounds = 3
    fed = FedConfig(n_clients=N_CLIENTS, staleness_decay="poly")
    cfg = train.forecast_cfg("mlp", 24)
    init = init_fed_state(torch.Generator().manual_seed(0),
                          lambda g: init_forecaster(g, cfg),
                          dataclasses.replace(fed, omega_optimizer="adam"),
                          device="cpu")
    arrays = {k: None if v is None else _to_numpy(v)
              for k, v in init._asdict().items()}
    rows = np.random.RandomState(1).rand(rounds, N_CLIENTS) < 0.6
    rows[:, 0] = True
    _, test, scalers = train.problem("milano", 24, N_CLIENTS, 0)
    out = {}
    for dev in ("cpu", "cuda"):
        state, _, hist = train.train_bafdp(
            "milano", 24, fed, rounds=rounds, seed=0, input_sigma=0.0,
            active_masks=rows, collect=("data_loss",),
            state=fed_state_from_numpy(arrays, device=dev), device=dev)
        out[dev] = (state, hist["data_loss"],
                    train.eval_fed_state(state, cfg, test, scalers))
    drift = 2e-5
    bound = rounds * 2 * fed.alpha_w
    worst, n_off = (0.0, ""), 0
    for (path, a), (_, b) in zip(_named_leaves(out["cpu"][0]._asdict()),
                                 _named_leaves(out["cuda"][0]._asdict())):
        a, b = a.double(), b.cpu().double()
        d = (a - b).abs()
        scale = 1e-4 * a.abs()
        if bool((d > bound + scale).any()):
            raise AssertionError(f"cpu vs cuda: {path} differs by "
                                 f"{float(d.max()):.3e} > {bound:.1e}")
        off = int((d > drift + scale).sum())
        if off > max(1, a.numel() // 100):
            raise AssertionError(f"cpu vs cuda: {path} has {off} of "
                                 f"{a.numel()} elements off by > {drift}")
        n_off += off
        if float(d.max()) > worst[0]:
            worst = (float(d.max()), path)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4)
    report["cpu_vs_cuda"] = dict(max_abs_state_diff=worst[0],
                                 worst_leaf=worst[1],
                                 elements_beyond_drift=n_off,
                                 rmse_mae_cpu=out["cpu"][2],
                                 rmse_mae_cuda=out["cuda"][2])
    log(f"cpu vs cuda, {rounds} rounds: max |state diff| = {worst[0]:.3e} "
        f"at {worst[1]}; {n_off} elements beyond the {drift} drift bound; "
        f"rmse/mae cpu {out['cpu'][2]} cuda {out['cuda'][2]}")


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, tree


def _to_numpy(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.numpy(), tree)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False     # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    report = {"card": card}

    t0 = time.perf_counter()
    lib = _build.build("sign_agg")
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {lib.name} in {report['build_s']:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  nvcc: {line.strip()}")

    from repro_torch.configs import MLP_H24
    from repro_torch.models.forecasting import init_forecaster
    from repro_torch.tree import tree_leaves

    leaf_d = [l.numel() for l in tree_leaves(
        init_forecaster(torch.Generator(), MLP_H24))]
    if leaf_d != MAIN_LEAF_D:
        raise AssertionError(f"MLP_H24 leaves {leaf_d} != {MAIN_LEAF_D}")

    specs = kernel_specs()
    t0 = time.perf_counter()
    check_kernels(specs, report)
    time_kernels(specs, report)
    report["kernel_phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_runs(specs, report)
    cpu_vs_cuda(report)
    report["train_phase_s"] = time.perf_counter() - t0

    kernels = [dict(name=s["name"], route="cuda", source=SOURCE,
                    replaces=s["replaces"], launches=s["launches"],
                    max_abs_err=s["max_abs_err"], ms=s["ms"],
                    plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                    bound_by=s["bound_by"], library_ms=None)
               for s in specs]
    report["kernels"] = kernels
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
