"""Three-term roofline analysis (assignment §ROOFLINE + the paper's purpose).

A copy of ``repro.core.roofline`` (no JAX; the port's tests hold it bit for bit
against the reference).

Terms, per (arch x shape x mesh) cell, following the assignment formulas with
per-device quantities (the compiled HLO is post-SPMD, i.e. per-device):

    compute    = flops_per_device    / peak_flops          [s]
    memory     = bytes_per_device    / hbm_bw              [s]
    collective = comm_bytes_per_dev  / link_bw             [s]

(equivalently  HLO_FLOPs_global / (chips x peak)  since
 HLO_FLOPs_global = chips x flops_per_device).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from .hlo import Program
from .hwspec import HardwareSpec


@dataclass
class Roofline:
    """Three-term roofline (compute / memory / collective) for one program
    on one spec (DESIGN.md §6); `as_dict` feeds reports and artifacts.
    """
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    comm_bytes_per_device: float
    model_flops_global: float          # 6ND (train) / 2ND (inference)
    hlo_flops_global: float
    n_chips: int
    mxu_utilization: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=lambda k: terms[k])

    @property
    def t_bound(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs: how much compiled compute is useful
        (catches remat recompute + routing/dispatch overhead + padding)."""
        return self.model_flops_global / max(self.hlo_flops_global, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """compute term / bound — 1.0 means pure-compute-limited (ideal for
        a training step); the headline §Perf number."""
        return self.compute_s / max(self.t_bound, 1e-30)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops(param_count_active: int, tokens: int, kind: str) -> float:
    """6*N*D for training (fwd+bwd), 2*N*D for inference forward."""
    if kind == "train":
        return 6.0 * param_count_active * tokens
    return 2.0 * param_count_active * tokens


def roofline_from_program(prog: Program, hw: HardwareSpec, n_chips: int,
                          model_flops_global: float,
                          compute_dtype: str = "bf16") -> Roofline:
    f = prog.flops
    b = prog.bytes_normalized(compute_dtype)
    c = prog.comm_normalized(compute_dtype)
    # memory roof: all traffic streamed from the hierarchy's outermost
    # level (HBM/DRAM) on the load path — the classic roofline denominator
    hbm = hw.memory_hierarchy()[-1]
    return Roofline(
        compute_s=f / hw.matmul_flops(compute_dtype),
        memory_s=b / hbm.read_bw,
        collective_s=c / hw.ici_bw_per_link,
        flops_per_device=f,
        bytes_per_device=b,
        comm_bytes_per_device=c,
        model_flops_global=model_flops_global,
        hlo_flops_global=f * n_chips,
        n_chips=n_chips,
        mxu_utilization=prog.matmul_utilization(hw.mxu_tile),
    )
