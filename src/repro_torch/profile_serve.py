"""Where a serving step's time goes on the GPU.

    python -m repro_torch.profile_serve [--arch smollm-360m]
        [--prefill-batch 4] [--prefill-len 4096] [--batch 8] [--prompt 16]
        [--max-new 16] [--cache-len 512]

``--arch``: any served config (``smollm-360m``, ``hymba-1.5b``,
``granite-moe-3b-a800m``, ``olmoe-1b-7b``, ``xlstm-1.3b``,
``seamless-m4t-medium``, ``llava-next-mistral-7b``).

With full-width random weights (seed 0), under ``torch.profiler`` after a
warm-up: one prefill step (``launch.steps.make_prefill_step``; its inputs
from ``launch.steps.prefill_inputs``: ``--prefill-len`` positions, of
which a VLM's first ``frontend_tokens`` are its patch prefix, and an
encoder-decoder's ``frontend_tokens`` frames beside them) and one
``ServeEngine.generate`` (prompts of ``--prompt`` tokens, prefilled token
by token, then ``--max-new`` new tokens; half greedy, half sampled; an
encoder-decoder against the engine's zero memory).  Prints for each:
wall ms (host clock, synchronized, profiler on), ms and kernels per step,
the device busy share (summed kernel time over wall time), the attention
kernels' (B4, B5) and the selective scan's (B6, Mamba and Hymba layers)
shares of the device time, for an MoE model the device ms and share of
each part of its FFN (``models/moe.SPANS``: routing and top-k, dispatch,
the per-call expert-weight casts, the expert ``bmm``s, combine), for
xLSTM the device ms and share of its mLSTM and sLSTM mixers
(``models/ssm.XLSTM_SPANS``), and the top operators by device and by host
time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.configs.base import MAMBA, MLSTM, SLSTM
from repro_torch.launch.steps import make_prefill_step, prefill_inputs
from repro_torch.models import moe, ssm
from repro_torch.models import transformer as tr
from repro_torch.serving import ServeEngine, ServeRequest
from repro_torch.tree import resolve_device

# kernel names of B4 (csrc/flash_attention.cu) and B5 (decode_attention.cu)
FLASH_KERNEL, DECODE_KERNEL = "flash_fwd", "decode_cluster"
ATTENTION_KERNELS = (FLASH_KERNEL, DECODE_KERNEL)
SCAN_KERNELS = ("ssm_scan_kernel",)          # B6 (csrc/ssm_scan.cu)
SPANS = moe.SPANS + ssm.XLSTM_SPANS


def span_times(events, names=moe.SPANS) -> dict:
    """{span: (device ms, host ms)} for each of ``names``, summed over its
    occurrences: a span's device time is that of the kernels launched
    inside it."""
    out = {name: [0.0, 0.0] for name in names}
    for e in events:
        if e.name in out and e.device_type == DeviceType.CPU:
            out[e.name][0] += e.device_time_total / 1e3
            out[e.name][1] += e.cpu_time_total / 1e3
    return {name: tuple(v) for name, v in out.items()}


def _profiled(fn, dev, steps: int, label: str, required) -> None:
    """Profile ``fn`` and print its breakdown; raises if no kernel whose
    name holds ``required`` ran (unless it is None: a model without
    attention), so a renamed kernel cannot count as 0 ms."""
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the spans' device-side copies are ranges, not kernels
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name not in SPANS]
    if required and not any(required in e.name for e in kernels):
        raise RuntimeError(f"{label}: no {required} kernel in the trace")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    attn_ms, scan_ms = (
        sum(e.time_range.elapsed_us() for e in kernels
            if any(n in e.name for n in names)) / 1e3
        for names in (ATTENTION_KERNELS, SCAN_KERNELS))
    print(f"{label}: wall_ms={wall_ms:.3f} (profiler on) steps={steps} "
          f"ms_per_step={wall_ms / steps:.3f} "
          f"kernels_per_step={len(kernels) / steps:.1f} "
          f"device_busy_ms_per_step={busy_ms / steps:.4f} "
          f"device_busy_share={busy_ms / wall_ms:.4f} "
          f"attention_kernel_ms_per_step={attn_ms / steps:.4f} "
          f"attention_share_of_busy={attn_ms / max(busy_ms, 1e-9):.4f} "
          f"scan_kernel_ms_per_step={scan_ms / steps:.4f} "
          f"scan_share_of_busy={scan_ms / max(busy_ms, 1e-9):.4f}")
    for part, names in (("MoE", moe.SPANS), ("xLSTM", ssm.XLSTM_SPANS)):
        spans = span_times(prof.events(), names)
        if any(host for _, host in spans.values()):
            print(f"{label} {part}: " + " ".join(
                f"{name}_ms_per_step={dev_ms / steps:.4f} "
                f"{name}_share_of_busy={dev_ms / max(busy_ms, 1e-9):.4f}"
                for name, (dev_ms, _) in spans.items()))
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=12))
    print(averages.table(sort_by="self_cpu_time_total", row_limit=15))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--prefill-batch", type=int, default=4)
    ap.add_argument("--prefill-len", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=512)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(args.arch)
    params = tr.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    print(f"card: {torch.cuda.get_device_name(dev)}")
    print(f"config: {vars(args)}")

    attends = any(k not in (MAMBA, MLSTM, SLSTM) for k in cfg.pattern())
    prefill = make_prefill_step(cfg)
    inputs = prefill_inputs(cfg, args.prefill_batch, args.prefill_len,
                            torch.Generator(device=dev).manual_seed(1))
    prefill(params, dict(inputs, tokens=inputs["tokens"][:, :256]))  # warm-up
    _profiled(lambda: prefill(params, inputs), dev, 1,
              f"prefill B={args.prefill_batch} S={args.prefill_len}",
              FLASH_KERNEL if attends else None)

    rng = np.random.RandomState(0)
    reqs = [ServeRequest(prompt=rng.randint(0, cfg.vocab_size, args.prompt)
                         .astype(np.int32), max_new=args.max_new,
                         temperature=0.0 if i % 2 == 0 else 0.7, rid=i)
            for i in range(args.batch)]
    ServeEngine(params, cfg, args.batch, args.cache_len, device=dev
                ).generate([ServeRequest(prompt=r.prompt, max_new=2)
                            for r in reqs])                    # warm-up
    eng = ServeEngine(params, cfg, args.batch, args.cache_len, device=dev)
    _profiled(lambda: eng.generate(reqs), dev, args.prompt + args.max_new,
              f"generate batch={args.batch} prompt={args.prompt} "
              f"max_new={args.max_new} cache={args.cache_len}",
              DECODE_KERNEL if attends else None)


if __name__ == "__main__":
    main()
