"""Kernel micro-benchmarks (the port of ``benchmarks/kernel_bench.py``):
each hand-written kernel at the reference's shapes, under the reference's
row names, with the least time one H100 could take for the same work
(``roofline.kernel_cost``) beside it.

``us_per_call`` is the kernel's device time on the card, by CUDA events
over a run of calls after a warm-up; ``derived`` holds
``h100_roofline_us`` (bytes or operations, whichever bounds the call) or,
for B4, ``h100_compute_us`` (operations only, as the reference's
``tpu_compute_us``), ``plain_us`` (the plain PyTorch version,
``kernels/ref.py``, on the same inputs and device), and the reference's
byte and wire figures unchanged.  Where the reference times an XLA
function that has no kernel (the Eq. (22) dual-wire fold, the streamed
consensus fold), the port times its own plain function and the row says
so (``timed=plain``).  On ``--device cpu`` every row times the plain
versions (a wrapper given CPU tensors runs its plain version) and still
prints the H100 bound.

    python -m repro_torch.bench.kernel_bench [--quick] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch

from repro_torch.bench import cli
from repro_torch.distributed.collectives import (dual_message_bytes,
                                                 encode_sign_message,
                                                 message_bytes)
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ref
from repro_torch.kernels import sign_agg as sa
from repro_torch.kernels import ssm_scan as ssm_k
from repro_torch.roofline import kernel_cost as kc
from repro_torch.tree import resolve_device

PSI, ALPHA = 0.01, 0.01
ITERS = 20


@dataclasses.dataclass
class Row:
    """One row: ``us`` the timed call's time (the kernel's on the card),
    ``derived`` the ``key=value`` items in order, ``kernel`` the
    ``LAUNCHES`` key its call advances (None where it times no kernel)
    and ``launches`` how far it advanced it, ``bound_us`` the H100 bound
    of the timed call (None for a row of byte counts)."""
    name: str
    us: float
    derived: List[str]
    kernel: Optional[str] = None
    launches: int = 0
    bound_us: Optional[float] = None

    def line(self) -> str:
        return f"{self.name},{self.us:.1f},{';'.join(self.derived)}"


def _counts() -> dict:
    return {**sa.LAUNCHES, **fa_k.LAUNCHES, **dec_k.LAUNCHES,
            **ssm_k.LAUNCHES}


def time_us(fn: Callable[[], object], dev: torch.device,
            iters: int = ITERS) -> float:
    """Mean time of ``fn()`` over ``iters`` calls after one warm-up call:
    by CUDA events on the card, by the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters * 1e3


def _kernel_row(name, dev, kernel, fn, plain, work, bound_key,
                fmt="{:.1f}", extra=()) -> Row:
    """Time ``fn`` (which launches ``kernel`` on the card) and ``plain``;
    the bound of ``work`` under ``bound_key``."""
    before = _counts()[kernel]
    us = time_us(fn, dev)
    launched = _counts()[kernel] - before
    plain_us = time_us(plain, dev)
    bound_us = (work.t_ops if bound_key == "h100_compute_us"
                else kc.bound_ms(work)[0] / 1e3) * 1e6
    derived = [f"{bound_key}={fmt.format(bound_us)}", *extra,
               f"plain_us={plain_us:.1f}"]
    return Row(name, us, derived, kernel, launched, bound_us)


def rows(quick: bool = False, device=None) -> List[Row]:
    """Every row, measured on ``device`` (the card unless "cpu")."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    out: List[Row] = []

    # sign_agg: bytes-bound
    C, D = 16, 2_000_000 if not quick else 200_000
    z, W, phi = randn(D), randn(C, D), torch.zeros(D, device=dev)
    out.append(_kernel_row(
        f"kernel/sign_agg_C{C}_D{D}", dev, "sign_agg",
        lambda: sa.sign_agg(z, W, phi, PSI, ALPHA),
        lambda: ref.sign_agg_ref(z, W, phi, PSI, ALPHA),
        kc.sign_agg_work(z, W), "h100_roofline_us"))
    sw = torch.linspace(0.1, 1.0, C, device=dev)
    out.append(_kernel_row(
        f"kernel/sign_agg_weighted_C{C}_D{D}", dev, "sign_agg_weighted",
        lambda: sa.sign_agg_weighted(z, W, phi, sw, PSI, ALPHA),
        lambda: ref.sign_agg_weighted_ref(z, W, phi, sw, PSI, ALPHA),
        kc.sign_agg_work(z, W, sw), "h100_roofline_us"))

    # the int8 wire of the weighted message: the (C, D) payload and the
    # (C,) f32 scale; this dense row's scope is "all", so fleet-wide
    # accounting is the right one here
    msg = encode_sign_message(z, W, sw)
    wire_f32 = sum(message_bytes(C, D, "f32"))
    wire_i8 = sum(message_bytes(C, D, "int8"))
    bytes_f32, bytes_i8 = wire_f32 + 2 * D * 4, wire_i8 + 2 * D * 4
    out.append(_kernel_row(
        f"kernel/sign_agg_weighted_int8_C{C}_D{D}", dev,
        "sign_agg_weighted_int8",
        lambda: sa.sign_agg_weighted_int8(z, msg.payload, msg.scale, phi,
                                          PSI, ALPHA),
        lambda: ref.sign_agg_int8_ref(z, msg.payload, msg.scale, phi, PSI,
                                      ALPHA),
        kc.sign_agg_int8_work(z, msg.payload, msg.scale), "h100_roofline_us",
        extra=(f"wire_bytes_f32={wire_f32}", f"wire_bytes_int8={wire_i8}",
               f"wire_ratio={wire_f32 / wire_i8:.2f}",
               f"h100_speedup_vs_f32={bytes_f32 / bytes_i8:.2f}")))

    # the active-subset round: B2 over the S gathered rows, n_total = C,
    # against B2 over the (C, D) block masked to the same S rows
    Cs, Ss, Ds = (4096, 64, 4096) if not quick else (512, 16, 512)
    Wc, zc = randn(Cs, Ds), randn(Ds)
    phic = torch.zeros(Ds, device=dev)
    w_mask = (torch.arange(Cs, device=dev) < Ss).float()
    gidx = torch.arange(Ss, device=dev)
    ones = torch.ones(Ss, device=dev)
    Wg = Wc[gidx]
    us_dense = time_us(lambda: sa.sign_agg_weighted(
        zc, Wc, phic, w_mask, PSI, ALPHA, n_total=Cs), dev)
    bytes_dense, bytes_sparse = Cs * Ds * 4, Ss * Ds * 4
    h100_dense = kc.bound_ms(kc.sign_agg_work(zc, Wc, w_mask))[0] * 1e3
    sparse = _kernel_row(
        f"kernel/sparse_round_consensus_C{Cs}_S{Ss}_D{Ds}", dev,
        "sign_agg_weighted",
        lambda: sa.sign_agg_weighted(zc, Wg, phic, ones, PSI, ALPHA,
                                     n_total=Cs),
        lambda: ref.sign_agg_fold_ref(zc, Wg, phic, ones, PSI, ALPHA, Cs),
        kc.sign_agg_work(zc, Wg, ones), "h100_roofline_us_sparse",
        fmt="{:.3f}")
    sparse.derived = [f"dense_us={us_dense:.1f}",
                      f"bytes_dense={bytes_dense}",
                      f"bytes_sparse={bytes_sparse}",
                      f"byte_ratio={bytes_dense / bytes_sparse:.0f}",
                      f"h100_roofline_us_dense={h100_dense:.2f}",
                      *sparse.derived]
    out.append(sparse)

    # sign-wire bytes, fleet-wide vs active-subset
    sw_fleet_f32 = sum(message_bytes(Cs, Ds, "f32"))
    sw_fleet_i8 = sum(message_bytes(Cs, Ds, "int8"))
    sw_act_f32 = sum(message_bytes(Ss, Ds, "f32"))
    sw_act_i8 = sum(message_bytes(Ss, Ds, "int8"))
    out.append(Row(f"kernel/sign_wire_bytes_C{Cs}_S{Ss}_D{Ds}", 0.0, [
        f"fleet_f32={sw_fleet_f32}", f"fleet_int8={sw_fleet_i8}",
        f"active_f32={sw_act_f32}", f"active_int8={sw_act_i8}",
        f"active_ratio={sw_act_f32 / sw_act_i8:.2f}",
        f"fleet_overstatement={sw_fleet_f32 / sw_act_f32:.0f}"]))

    # the Eq. (22) dual wire: no kernel in either package (XLA in the
    # reference), so the plain folds are timed
    phi_rows = randn(Ss, Ds)
    w_act = torch.ones(Ss, device=dev)
    us_dual_f32 = time_us(lambda: ref.fold_weighted_rowsum(phi_rows, w_act),
                          dev)
    us_dual_i8 = time_us(lambda: ref.fold_dual_rowsum(phi_rows, w_act), dev)
    dw_f32 = sum(dual_message_bytes(Ss, Ds, "f32"))
    dw_i8 = sum(dual_message_bytes(Ss, Ds, "int8"))
    out.append(Row(f"kernel/dual_wire_S{Ss}_D{Ds}", us_dual_i8, [
        f"f32_us={us_dual_f32:.1f}", f"dual_bytes_f32={dw_f32}",
        f"dual_bytes_int8={dw_i8}", f"dual_wire_ratio={dw_f32 / dw_i8:.2f}",
        "timed=plain"]))

    # the streamed fold (plain, no kernel, as in the reference) against
    # the materialized fold, B2 over the (S, D) block
    chunk = 8
    before = _counts()["sign_agg_weighted"]
    us_mat = time_us(lambda: sa.sign_agg_weighted(
        zc, Wg, phic, ones, PSI, ALPHA, n_total=Cs), dev)
    launched = _counts()["sign_agg_weighted"] - before
    us_str = time_us(lambda: ref.sign_agg_fold_stream_ref(
        zc, Wg, phic, ones, PSI, ALPHA, Cs, chunk), dev)
    blk_mat, blk_str = Ss * Ds * 4, chunk * Ds * 4
    out.append(Row(f"kernel/streamed_fold_S{Ss}_D{Ds}_chunk{chunk}", us_str, [
        f"materialized_us={us_mat:.1f}",
        f"peak_block_bytes_materialized={blk_mat}",
        f"peak_block_bytes_streamed={blk_str}",
        f"block_ratio={blk_mat / blk_str:.0f}", "timed=plain"],
        "sign_agg_weighted", launched))

    # flash attention (B4): operations-bound
    B, S, H, Dh = (2, 1024, 8, 64) if not quick else (1, 256, 4, 64)
    q, k, v = randn(B, S, H, Dh), randn(B, S, H // 2, Dh), \
        randn(B, S, H // 2, Dh)
    out.append(_kernel_row(
        f"kernel/flash_attn_B{B}_S{S}_H{H}", dev, "flash_attention",
        lambda: fa_k.flash_attention(q, k, v),
        lambda: ref.flash_attention_ref(q, k, v),
        kc.flash_work(q, k, True, 0), "h100_compute_us", fmt="{:.2f}"))

    # decode attention (B5): bytes-bound, every cache position valid
    L = 32_768 if not quick else 2048
    q1 = randn(B, H, Dh)
    kc_, vc_ = randn(B, L, H // 2, Dh), randn(B, L, H // 2, Dh)
    length = torch.full((B,), L, dtype=torch.int32, device=dev)
    out.append(_kernel_row(
        f"kernel/decode_attn_L{L}", dev, "decode_attention",
        lambda: dec_k.decode_attention(q1, kc_, vc_, length),
        lambda: ref.decode_attention_ref(q1, kc_, vc_, length),
        kc.decode_work(q1, kc_, B * L), "h100_roofline_us"))

    # ssm scan (B6): bytes-bound
    Bs, Ss2, Ds2, Ns = (2, 1024, 256, 16) if not quick else (1, 256, 64, 8)
    a = torch.rand((Bs, Ss2, Ds2, Ns), generator=g, device=dev) * 0.49 + 0.5
    b = randn(Bs, Ss2, Ds2, Ns) * 0.1
    h0 = torch.zeros((Bs, Ds2, Ns), device=dev)
    out.append(_kernel_row(
        f"kernel/ssm_scan_S{Ss2}_D{Ds2}", dev, "ssm_scan",
        lambda: ssm_k.ssm_scan(a, b, h0),
        lambda: ref.ssm_scan_ref(a, b, h0),
        kc.scan_work(a, h0), "h100_roofline_us"))
    return out


def main(rounds: int = 0, quick: bool = False, device=None) -> List[str]:
    lines = []
    for r in rows(quick, device):
        lines.append(r.line())
        print(lines[-1], flush=True)
    return lines


if __name__ == "__main__":
    cli(main, __doc__)
