"""Build the hand-written CUDA kernels at first use, load them, and the
helpers every ``ctypes`` wrapper shares.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, bound with ``ctypes``.  The build
goes into ``build/repro_torch_kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source and of the
headers it may include (``csrc/*.cuh``), so an edited source or header is
rebuilt.  Importing this module does nothing; the first
:func:`load` of a library builds it.  A failed build raises: there is no
fallback to the plain versions.  :func:`build_all` compiles every source
at once, one ``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sign_agg", "flash_attention", "flash_attention_bwd",
           "decode_attention", "ssm_scan")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# The devices a wrapper takes its kernel's path on: the GPU, where it
# launches the kernel, and ``meta``, where it launches nothing and adds the
# kernel's work to the active ``roofline.cost.CostCounter`` (the dry-run)
KERNEL_DEVICES = ("cuda", "meta")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes (hash of the source and
    of every header in ``csrc/``)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its build exists.  nvcc's output
    (with ptxas register and spill counts) is kept beside the library in
    ``<lib>.log``.  Raises on any compiler error."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)       # atomic: a concurrent loader sees all or none
    return out


def build_all() -> List[Path]:
    """Build every source of ``SOURCES``, one ``nvcc`` each, all started
    together; returns the libraries in ``SOURCES`` order."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return list(pool.map(build, SOURCES))


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if it is not yet; callers
    keep the handle (each wrapper module's ``_lib`` caches it)."""
    return ctypes.CDLL(str(build(name)))


def check_launch(err: int, kernel: str) -> None:
    """Raise unless a library call returned ``cudaSuccess`` (0)."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed: cudaError_t "
                           f"{err}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a ``ctypes`` int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` for a CUDA (or ``meta``) call under
    autograd (grad mode on, an input requiring grad) of a kernel with no
    backward yet: its output would carry no gradient.  CPU calls run the
    plain version, which autograd differentiates."""
    if (torch.is_grad_enabled() and tensors[0].device.type in KERNEL_DEVICES
            and any(t.requires_grad for t in tensors)):
        raise NotImplementedError(f"{kernel}'s backward is not yet ported")
