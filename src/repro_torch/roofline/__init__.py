"""The H100 roofline (the port of the JAX package's ``roofline/``):
``kernel_cost`` (the one count of each hand-written kernel's work and the
card's constants), ``cost`` (a step's FLOPs, bytes and memory, counted
while it runs on ``meta`` tensors) and ``analysis`` (the three-term
report)."""
from repro_torch.roofline.analysis import (H100, Hardware, RooflineReport,
                                           analyze, model_flops_for)

__all__ = ["H100", "Hardware", "RooflineReport", "analyze",
           "model_flops_for"]
