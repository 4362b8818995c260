"""The paper's own evaluation workload (Table 1 + Figs 4/5).

A copy of ``repro.configs.a64fx_kernelsuite``.

28 single-core kernels (basic arithmetic / type conversion / numeric /
mathematical) with array sizes chosen as 3/4 of L1 as in the paper, plus
Stream Triad at L2-resident and 2x-L2 sizes.  Consumed by
``repro_torch.core.calibrate``.

Each entry: (name, type, n, expression-id).  ``n`` follows Table 1.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Kernel:
    """One Table-1 kernel: name, type, n and the expression it computes."""
    name: str
    ktype: str           # arith | conv | numeric | math
    n: int               # innermost array length (Table 1 'Size')
    expr: str            # expression id understood by kernels/stream.py


# Table 1, verbatim.
KERNELS = [
    Kernel("add",   "arith",   2048, "y = x1 + x2"),
    Kernel("sub",   "arith",   2048, "y = x1 - x2"),
    Kernel("mul",   "arith",   2048, "y = x1 * x2"),
    Kernel("fma",   "arith",   3072, "y = y + c0 * x1"),
    Kernel("div",   "arith",   2048, "y = x1 / x2"),
    Kernel("rev",   "arith",   3072, "y = 1 / x1"),
    Kernel("sqrt",  "arith",   3072, "y = sqrt(x1)"),
    Kernel("f2d",   "conv",    4096, "y_r8 = dble(x1_r4)"),
    Kernel("i2d",   "conv",    4096, "y_r8 = dble(x1_i4)"),
    Kernel("d2f",   "conv",    4096, "y_r4 = real(x1_r8)"),
    Kernel("d2i",   "conv",    4096, "y_i4 = int(x1_r8)"),
    Kernel("aint",  "conv",    3072, "y_r8 = aint(x1_r8)"),
    Kernel("nint",  "conv",    4096, "y_i4 = nint(x1_r8)"),
    Kernel("anint", "conv",    3072, "y_r8 = anint(x1_r8)"),
    Kernel("abs",   "numeric", 3072, "y = abs(x1)"),
    Kernel("max",   "numeric", 2048, "y = max(x1, x2)"),
    Kernel("min",   "numeric", 2048, "y = min(x1, x2)"),
    Kernel("mod",   "numeric", 2048, "y = mod(x1, x2)"),
    Kernel("sign",  "numeric", 2048, "y = sign(x1, x2)"),
    Kernel("atan",  "math",    3072, "y = atan(x1)"),
    Kernel("atan2", "math",    2048, "y = atan2(x1, x2)"),
    Kernel("cos",   "math",    3072, "y = cos(x1)"),
    Kernel("sin",   "math",    3072, "y = sin(x1)"),
    Kernel("exp",   "math",    3072, "y = exp(x1)"),
    Kernel("exp10", "math",    3072, "y = exp10(x1)"),
    Kernel("log",   "math",    3072, "y = log(x1)"),
    Kernel("log10", "math",    3072, "y = log10(x1)"),
    Kernel("pwr",   "math",    2048, "y = x1 ** x2"),
]

KERNELS_BY_NAME = {k.name: k for k in KERNELS}

# Stream Triad sizes (paper §5.2): L2-resident and 2x L2.  The paper's L2 is
# 8 MiB/CMG; we keep the same footprint ratios and scale per-"core" with
# thread count in the benchmark (1..12 threads as in Figs 4/5).
TRIAD_L2_BYTES = 6 * 2**20        # 3 arrays fit in 8 MiB L2 with headroom
TRIAD_MEM_BYTES = 16 * 2**20      # 2x the L2 capacity
TRIAD_THREADS = list(range(1, 13))

# Paper's measured accuracy (Fig. 3 summary) — targets the calibration
# benchmark reproduces: mean diff 1.3%, stddev 7.8%, mean |diff| 6.6%,
# >=80% of kernels within +-10%.
PAPER_MEAN_DIFF_PCT = 1.3
PAPER_STD_DIFF_PCT = 7.8
PAPER_MEAN_ABS_DIFF_PCT = 6.6
PAPER_WITHIN_10PCT_FRACTION = 23 / 28
