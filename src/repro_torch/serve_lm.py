"""Serving example: batched generation from a model-zoo architecture with
the batched decode engine (greedy + sampled requests, ring-buffer
sliding-window cache demo), the port of the JAX package's
``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.serve_lm [--arch olmoe-1b-7b] \
        [--max-new 24] [--window 0] [--device cpu]

The smoke scale of ``--arch`` (``reduce_for_smoke``), random weights
drawn from seed 0 on the CPU and then moved to the device, so every
device serves the same weights; an engine of batch 4 and cache 256
(``--window`` > 0: a ring of that many slots) serves the example's four
requests (:func:`requests`).  On the GPU unless ``--device cpu``
(raises when there is no GPU).  B5 runs in every attention layer of
every step, prompt included.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

BATCH, CACHE_LEN = 4, 256


def requests(cfg, max_new: int = 24):
    """The example's four requests, drawn from ``RandomState(0)`` in its
    order: prompts of 8, 5, 12 and 3 tokens; temperatures 0, 0.8, 0.5
    and 0 (requests 0 and 3 greedy); ``max_new`` new tokens each but
    request 1's ``max_new // 2``."""
    from repro_torch.serving import ServeRequest

    rng = np.random.RandomState(0)
    spec = ((8, max_new, 0.0), (5, max_new // 2, 0.8), (12, max_new, 0.5),
            (3, max_new, 0.0))
    return [ServeRequest(prompt=rng.randint(0, cfg.vocab_size, n).astype(
                np.int32), max_new=m, temperature=t, rid=i)
            for i, (n, m, t) in enumerate(spec)]


def serve(params, cfg, max_new: int = 24, window: int = 0, device=None,
          seed: int = 0):
    """:func:`requests` through a ``ServeEngine`` (batch 4, cache 256,
    ``window``) on ``device``: (requests, outputs, seconds, engine); the
    seconds end after the device has finished."""
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(params, cfg, batch=BATCH, cache_len=CACHE_LEN,
                      window=window, seed=seed, device=device)
    reqs = requests(cfg, max_new)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs, outs, time.perf_counter() - t0, eng


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke
    from repro_torch.models import transformer as tr
    from repro_torch.tree import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b", choices=sorted(ARCHS))
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--window", type=int, default=0,
                    help=">0: sliding-window ring-buffer cache")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduce_for_smoke(get_arch(args.arch))
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg, device=dev)
    n = sum(p.numel() for p in params.parameters())
    print(f"serving {cfg.name} ({n/1e6:.1f}M params, smoke scale), "
          f"window={args.window or 'full cache'}")
    reqs, outs, dt, _ = serve(params, cfg, args.max_new, args.window, dev)
    total = sum(len(o) for o in outs)
    for r, o in zip(reqs, outs):
        print(f"  req {r.rid} (T={r.temperature}): prompt {len(r.prompt)} "
              f"tokens -> {o.tolist()}")
    print(f"{total} tokens in {dt:.1f}s "
          f"({total/dt:.1f} tok/s batched, {dev.type} smoke scale)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
