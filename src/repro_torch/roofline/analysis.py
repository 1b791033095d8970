"""Three-term roofline of a step on one H100 SXM (the port of the JAX
package's ``roofline/analysis.py``).

    compute    = sum over rate classes of FLOPs / the class's peak rate
    memory     = HBM bytes / HBM bandwidth
    collective = collective bytes / link bandwidth

The counts come from running the step on ``meta`` tensors under
:class:`~repro_torch.roofline.cost.CostCounter` (:func:`analyze`), where
the reference parses a compiled program.  The compute term is summed per
rate class (``kernel_cost.RATES``): the port's f32 products run without
TF32 at 67 TFLOP/s, B4 in f32 and its backward as 3xTF32, bf16 at 989
TFLOP/s; dividing everything by the bf16 peak, as the reference divides
by its one peak, would understate an f32 round's compute term ~14.8x.  A
report given only a total (``flops_by_class`` empty) divides it by
``Hardware.peak_flops``, as the reference does.  The memory term keeps the
reference's estimate, arguments + outputs + 2 x temporaries.  The
collective term sums the exchanges the step made
(``distributed.collectives``, counted by the ``CostCounter``), each a
ring all-reduce's ``2 (n - 1) / n`` of its bytes over the slowest link of its group: NVLink within a node of 8 GPUs, the
InfiniBand port between nodes (``kernel_cost.collective_s``; a group's
span from the mesh's row-major rank order, ``"model"`` innermost).  A
model, not a measurement: no link was timed.  On one device no
collective runs, so the term is 0.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

from repro_torch.roofline import kernel_cost as kc


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per chip, bf16 dense (for mfu)
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per link
    hbm_per_chip: float        # bytes
    rates: Optional[Dict[str, float]] = None     # per rate class

    def rate(self, cls: str) -> float:
        return (self.rates or {}).get(cls, self.peak_flops)


H100 = Hardware(name="h100_sxm", peak_flops=kc.BF16_FLOPS_PER_S,
                hbm_bw=kc.HBM_BYTES_PER_S, link_bw=kc.NVLINK_BYTES_PER_S,
                hbm_per_chip=kc.HBM_BYTES, rates=dict(kc.RATES))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # counted on meta (cost.CostCounter)
    flops: float
    dot_flops: float
    hbm_bytes: float
    hbm_op_bytes_upper: float
    collective_bytes: float
    collectives: Dict[str, float]
    # the reference's cost_analysis cross-check: the same count here (the
    # port has no compiler whose count could differ)
    xla_flops: float
    xla_bytes: float
    # memory
    bytes_per_device: float
    argument_bytes: float
    output_bytes: float
    temp_bytes: float
    # model-level
    model_flops: float         # 6 * N_active * D
    flops_by_class: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    kernel_flops: float = 0.0  # the hand-written kernels' share of flops
    # derived terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    # the collective term from the counted exchanges' link model (seconds);
    # None: collective_bytes over one link, as the reference
    collective_s: Optional[float] = None
    hw: Hardware = H100

    def finalize(self, hw: Hardware = H100) -> "RooflineReport":
        """The three terms on ``hw``, per device: the counts are one
        device's."""
        self.hw = hw
        if self.flops_by_class:
            self.t_compute = sum(f / hw.rate(c)
                                 for c, f in self.flops_by_class.items())
        else:
            self.t_compute = self.flops / hw.peak_flops
        self.t_memory = self.hbm_bytes / hw.hbm_bw
        self.t_collective = (self.collective_bytes / hw.link_bw
                             if self.collective_s is None
                             else self.collective_s)
        return self

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """(model FLOPs per chip) / (counted FLOPs per chip): <1 means
        remat / replicated-compute / routing waste; >1 that the count
        missed compute (or, for attention-heavy shapes, that B4 skips the
        pairs its mask removes)."""
        return (self.model_flops / self.chips) / max(self.flops, 1.0)

    @property
    def step_time(self) -> float:
        """Roofline-optimistic step time: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline-optimistic step time,
        against the hardware's bf16 peak (the reference's definition)."""
        return (self.model_flops / self.chips) \
            / (self.step_time * self.hw.peak_flops + 1e-30)

    def row(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "hbm_op_bytes_upper": self.hbm_op_bytes_upper,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "mfu_at_roofline": self.mfu,
            "bytes_per_device": self.bytes_per_device,
            "xla_flops": self.xla_flops,
            "collectives": self.collectives,
        }

    def to_json(self) -> str:
        return json.dumps(self.row())


def analyze(counter, out: Any, *, arch: str, shape: str, mesh_name: str,
            chips: int, model_flops: float,
            hw: Hardware = H100) -> RooflineReport:
    """The report of a step counted by ``counter``
    (``cost.CostCounter``), whose result was ``out``.  Temporaries are
    the peak of the step's live bytes less its outputs, so arguments +
    outputs + temporaries is the step's peak with its arguments
    resident."""
    coll: Dict[str, float] = {}
    for _, axis, nbytes, _, _ in counter.collectives:
        coll[axis] = coll.get(axis, 0.0) + float(nbytes)
    coll_s = sum(kc.collective_s(kind, nbytes, size, stride)
                 for kind, _, nbytes, size, stride in counter.collectives)
    arg_b = float(counter.argument_bytes)
    out_b = float(counter.output_bytes(out))
    tmp_b = float(max(counter.peak_bytes - out_b, 0))
    report = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops=counter.flops, dot_flops=counter.dot_flops,
        hbm_bytes=arg_b + out_b + 2.0 * tmp_b,
        hbm_op_bytes_upper=counter.hbm_op_bytes,
        collective_bytes=sum(coll.values()), collectives=coll,
        collective_s=coll_s, xla_flops=counter.flops,
        xla_bytes=counter.hbm_op_bytes,
        bytes_per_device=arg_b + out_b + tmp_b,
        argument_bytes=arg_b, output_bytes=out_b, temp_bytes=tmp_b,
        model_flops=model_flops,
        flops_by_class=dict(counter.flops_by_class),
        kernel_flops=counter.kernel_flops)
    return report.finalize(hw)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); decode D = batch
    (one token per sequence)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    return 2.0 * n * shape.global_batch  # decode: 1 token / sequence
