"""Multi-port occupancy engine — the O3-pipeline analogue at HLO altitude.

A copy of ``repro.core.engine`` (no JAX; the port's tests hold it bit for bit
against the reference).

gem5 models instruction issue into reservation stations; at HLO altitude the
equivalent resources are *ports*: MXU (matrix), VPU (vector), DMA (HBM), ICI
(interconnect).  Every op contributes occupancy to its port; the overlap
model (paper: OoO execution hiding memory latency; here: XLA async DMA /
async collectives) combines port totals into an execution-time estimate:

    compute      = t_mxu + t_vpu
    mem_exposed  = max(0, t_mem - dma_overlap * compute)
    ici_exposed  = max(0, t_ici - ici_overlap * compute)
    t_est        = compute + mem_exposed + ici_exposed + startup
    t_roofline   = max(t_mxu + t_vpu, t_mem, t_ici)      (perfect overlap)

Per-op times come from the unified cost pipeline (``core.cost``): memory
time is routed through the multi-level hierarchy (``core.memory``), and
collective times use ring-algorithm factors on ``group_size`` with a
bidirectional ring (2 links) per collective.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# re-exported for backward compatibility: the cost model used to live here
from .cost import OpTime, collective_factor, cost_op, cost_program  # noqa: F401
from .hlo import Program
from .hwspec import HardwareSpec
from .memory import aggregate_traffic


@dataclass
class EngineResult:
    """Occupancy-engine output: per-port busy sums composed with the
    configured overlap fractions (DESIGN.md §6).
    """
    port_busy: Dict[str, float]
    t_est: float
    t_roofline: float
    t_serial: float
    n_ops: float
    startup: float
    mxu_utilization: float
    by_class_time: Dict[str, float]
    top_ops: List[OpTime]
    collective_time_by_kind: Dict[str, float]
    # per-memory-level totals (count-multiplied read/write bytes), for the
    # PA report's hierarchy section
    traffic_by_level: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def bound_by(self) -> str:
        if not self.port_busy:
            return "mem"
        return max(self.port_busy, key=lambda k: self.port_busy[k])


def simulate_program(prog: Program, hw: HardwareSpec,
                     links_per_collective: int = 2,
                     compute_dtype: Optional[str] = None,
                     costed: Optional[List[Optional[OpTime]]] = None
                     ) -> EngineResult:
    """``compute_dtype``: the model's intended compute dtype.  When set to a
    16-bit type, f32 ops are costed as that type (flops AND bytes AND
    collective payloads).  This inverts XLA:CPU's float-normalization pass
    (the host has no native bf16, so the partitioned module we parse holds
    f32-promoted dots/buffers that the TPU target executes natively in
    bf16) — the paper's operand-type-dependent OpClass table, applied in
    reverse.  f32-by-design state (optimizer moments, the loss) is also
    halved; it is step-frequency (not layer x microbatch frequency) traffic,
    so the error is bounded and documented in DESIGN.md §7.

    ``costed``: a precomputed ``cost_program`` list, so callers running
    both engines (or several reports) pay for costing exactly once.
    """
    if costed is None:
        costed = cost_program(prog, hw, links_per_collective, compute_dtype)
    port_busy: Dict[str, float] = defaultdict(float)
    by_class: Dict[str, float] = defaultdict(float)
    coll_kind: Dict[str, float] = defaultdict(float)
    op_times: List[OpTime] = []
    t_serial = 0.0
    startup = 0.0
    n_ops = 0.0
    useful_f, padded_f = 0.0, 0.0

    for ot in costed:
        if ot is None:
            continue
        o = ot.op
        t_c, t_m, t_i, port = ot.t_compute, ot.t_mem, ot.t_ici, ot.port
        useful_f += ot.useful_flops
        padded_f += ot.padded_flops
        if o.opclass == "collective":
            coll_kind[o.opcode] += t_i * o.count

        if port in ("mxu", "vpu"):
            port_busy[port] += t_c * o.count
        port_busy["mem"] += t_m * o.count
        port_busy["ici"] += t_i * o.count
        by_class[o.opclass] += max(t_c, t_m, t_i) * o.count
        t_serial += max(t_c, t_m, t_i) * o.count
        startup += hw.op_startup_ns * 1e-9 * o.count
        n_ops += o.count
        op_times.append(ot)

    # .get, not [] — indexing the defaultdict would materialize phantom
    # zero ports and break bound_by's empty-program fallback
    compute = port_busy.get("mxu", 0.0) + port_busy.get("vpu", 0.0)
    mem_exposed = max(0.0, port_busy.get("mem", 0.0)
                      - hw.dma_overlap * compute)
    ici_exposed = max(0.0, port_busy.get("ici", 0.0)
                      - hw.ici_overlap * compute)
    t_est = compute + mem_exposed + ici_exposed + startup
    t_roofline = max(compute, port_busy.get("mem", 0.0),
                     port_busy.get("ici", 0.0))

    traffic = aggregate_traffic([t.traffic for t in op_times],
                                [t.op.count for t in op_times])

    op_times.sort(key=lambda t: -(t.t_op * t.op.count))
    return EngineResult(
        port_busy=dict(port_busy),
        t_est=t_est,
        t_roofline=t_roofline,
        t_serial=t_serial + startup,
        n_ops=n_ops,
        startup=startup,
        mxu_utilization=(useful_f / padded_f) if padded_f else 1.0,
        by_class_time=dict(by_class),
        top_ops=op_times[:20],
        collective_time_by_kind=dict(coll_kind),
        traffic_by_level=traffic,
    )
