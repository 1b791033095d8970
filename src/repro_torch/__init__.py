"""PyTorch / CUDA port of the BAFDP reproduction for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it.  Entry points take an explicit ``device``: ``None`` means the GPU,
and raises when there is none (no silent CPU fallback)."""
