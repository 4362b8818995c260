"""Calibration & accuracy evaluation on the H100 — the paper's §5 methodology.

The paper tunes gem5 with Fujitsu's parameters, then validates the simulator
against the A64FX *test chip* on 28 kernels.  The reference
(``repro.core.calibrate``) had only its CPU host as a test chip; the port has
the H100, and times the hand-written Table-1 kernels (K1) and STREAM Triad
(K2) on it:

  1. FIT the ``H100`` HardwareSpec from K1/K2 microbenchmarks
     (:func:`fit_h100`: Horner-16 -> ALU rate, L2- and HBM-resident ``add``
     and a pure-store fill -> per-level bandwidths, the transcendental
     kernels -> per-opcode factors, one-block launches -> op startup), then
  2. EVALUATE the simulator on all 28 Table-1 kernels
     (:func:`kernel_accuracy_table`): measured time of each K1 launch vs the
     simulated estimate of the same launch's program, reported exactly like
     Fig. 3 (mean / stddev / mean|.| / fraction within 10%), then
  3. TUNE the O3 resource knobs against the table (:func:`sweep_o3`), and
  4. sweep Triad over the number of CTAs (:func:`triad_scaling`), the
     Figs. 4/5 analogue.

:func:`fit_cpu_host` fits the reference's second test chip, the CPU host,
from the plain K1 functions in f64, by the reference's formulas.

The program of each kernel comes from :func:`kernel_program`, not from a
compiler: see its docstring.  Array sizes follow the reference's
``SIZE_SCALE`` (Table 1's n x 1024), which on the H100 makes working sets of
16-48 MB around its 50 MB L2.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..configs.a64fx_kernelsuite import KERNELS, KERNELS_BY_NAME, Kernel
from ..device import resolve
from ..kernels import ops
from ..kernels.stream import DTYPES, EXPRS
from .hlo import OpStat, Program
from .hwspec import CPU_HOST, H100, HardwareSpec
from .simulate import simulate

SIZE_SCALE = 1024     # the reference's: Table 1's n x1024
REPEATS = 15          # timed calls per measurement, after one warm-up

# The operations one K1 launch runs per element, by the HLO opcode names
# that hwspec's per-opcode tables use: (transcendental, plain elementwise).
# An operation without an HLO opcode of its own is named by the opcode of
# the same cost on the card: trunc (aint, mod) is an f64 rounding like rint
# (FRND), so "round-nearest-even"; copysign (sign) is a bitwise merge of the
# sign bit (LOP3), so "and"; atan is atan2 with x = 1, as XLA writes it;
# exp2 (exp10) is "exponential" and log10 is "log" plus a multiply, as XLA
# writes them.
K1_OPS: Dict[str, tuple] = {
    "add": ({}, {"add": 1}),
    "sub": ({}, {"subtract": 1}),
    "mul": ({}, {"multiply": 1}),
    "fma": ({}, {"multiply": 1, "add": 1}),
    "div": ({"divide": 1}, {}),
    "rev": ({"divide": 1}, {}),
    "sqrt": ({"sqrt": 1}, {}),
    "f2d": ({}, {"convert": 1}),
    "i2d": ({}, {"convert": 1}),
    "d2f": ({}, {"convert": 1}),
    "d2i": ({}, {"convert": 1}),
    "aint": ({}, {"round-nearest-even": 1}),
    "nint": ({}, {"round-nearest-even": 1, "convert": 1}),
    "anint": ({}, {"round-nearest-even": 1}),
    "abs": ({}, {"abs": 1}),
    "max": ({}, {"maximum": 1}),
    "min": ({}, {"minimum": 1}),
    "mod": ({"divide": 1}, {"round-nearest-even": 1, "multiply": 1,
                            "subtract": 1}),
    "sign": ({}, {"abs": 1, "and": 1}),
    "atan": ({"atan2": 1}, {}),
    "atan2": ({"atan2": 1}, {}),
    "cos": ({"cosine": 1}, {}),
    "sin": ({"sine": 1}, {}),
    "exp": ({"exponential": 1}, {}),
    "exp10": ({"exponential": 1}, {"multiply": 1}),
    "log": ({"log": 1}, {}),
    "log10": ({"log": 1}, {"multiply": 1}),
    "pwr": ({"log": 1, "exponential": 1}, {"multiply": 1}),
}
_HLO_DTYPES = {"f8": "f64", "f4": "f32", "i4": "s32"}
_ITEMSIZE = {"f8": 8, "f4": 4, "i4": 4}


def kernel_program(name: str, n: int) -> Program:
    """The program of one K1 launch of expression ``name`` over ``n``
    elements: one ``OpStat``, as the reference's parser would cost one loop
    fusion.

    This stands in for the reference's ``jax.jit(...).lower().compile()``
    and ``parse_program`` of the same expression (``calibrate.py:294-297``).
    The port imports no JAX, and it needs no compiler here: a K1 launch is
    one pass over ``n`` elements, and its arrays and operations are known
    exactly (``K1_OPS``).  So the description is written down:

    * ``read_bytes``/``write_bytes`` are the arrays K1 touches, once each,
      in their dtypes (x2 only for two-input expressions, y0 only for fma);
    * ``trans_by_opcode``/``vpu_by_opcode`` count K1's operations per
      element by HLO opcode, and ``flops``/``transcendentals`` follow the
      parser's rule, one per element per operation.  XLA's constant
      ``broadcast``s are not operations of K1;
    * the opclass is ``elementwise``, as the parser classes every loop
      fusion (so ``cost_op`` charges the plain operations beside the
      transcendental ones).

    ``tests/test_torch_kernel_program.py`` holds this against the
    reference's parse, with the differences named there.
    """
    trans, vpu = K1_OPS[name]
    fn, n_in, din, dout = EXPRS[name]
    reads = _ITEMSIZE[din] * (1 + (n_in == 2)) + _ITEMSIZE[dout] * (name == "fma")
    rd, wr = float(reads * n), float(_ITEMSIZE[dout] * n)
    n_trans = sum(trans.values())
    op = OpStat(f"k1_{name}", "fusion", "elementwise", _HLO_DTYPES[dout],
                flops=float((n_trans + sum(vpu.values())) * n),
                transcendentals=float(n_trans * n),
                bytes_accessed=rd + wr, read_bytes=rd, write_bytes=wr,
                trans_by_opcode={k: float(v * n) for k, v in trans.items()},
                vpu_by_opcode={k: float(v * n) for k, v in vpu.items()})
    return Program(ops=[op], entry=f"k1_{name}", n_partitions=1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# The spin queued ahead of each timed call: at least SPIN_CYCLES device
# cycles (~100 µs at the H100's clock), and at least twice as long as the
# host took to queue the previous call, counted at SPIN_HZ (the H100's
# highest SM clock; a slower clock only lengthens the spin).
SPIN_CYCLES = 200_000
SPIN_HZ = 1.98e9


def _median_time(fn: Callable, args, repeats: int = REPEATS) -> float:
    """Median seconds of ``fn(*args)`` over ``repeats`` calls after one
    warm-up: CUDA events around each call on the card, the host clock on
    the CPU.  Caches stay warm between repeats, as in the reference.

    On the card each call is queued behind a device-side spin
    (``torch.cuda._sleep``, no memory traffic) longer than the host takes
    to queue it (~20-30 µs of Python and launch for a K1 launch, ~0.2 ms
    for the SSD backward's wrapper), so that cost is hidden and the events
    see the card's time from the first event to the last kernel's end.
    Each spin is sized from the previous timed call's queuing time (the
    first is SPIN_CYCLES long: the warm-up's time may hold one-time work,
    such as building the kernel)."""
    device = args[0].device
    fn(*args)
    _sync(device)
    host, ts = 0.0, []
    for _ in range(repeats):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(max(SPIN_CYCLES, int(2 * host * SPIN_HZ)))
            e0.record()
            t0 = time.perf_counter()
            fn(*args)
            host = time.perf_counter() - t0
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _kernel_inputs(k: Kernel, n: int, gen: torch.Generator,
                   device: torch.device):
    """x1, x2, y0 distributed as the reference's ``_kernel_inputs``: ints in
    [-1000, 1000) for i4, else |N(0, 1)| + 0.5 in the input dtype; x2 in
    f64 when x1 is i4; y0 zeros."""
    fn, n_in, din, dout = EXPRS[k.name]

    def pos_normal(dtype):
        return (torch.randn(n, generator=gen, device=device,
                            dtype=torch.float64).abs() + 0.5).to(dtype)

    if din == "i4":
        x1 = torch.randint(-1000, 1000, (n,), generator=gen, device=device,
                           dtype=torch.int32)
    else:
        x1 = pos_normal(DTYPES[din])
    x2 = pos_normal(DTYPES["f8" if din == "i4" else din])
    y0 = torch.zeros(n, dtype=DTYPES[dout], device=device)
    return x1, x2, y0


def _k1(name: str):
    def f(x1, x2, y0):
        return ops.elementwise(name, x1, x2, y0)
    return f


def measure_launch_overhead(device="cuda") -> float:
    """Seconds of one K1 ``add`` launch on one block (2048 elements): CUDA
    events around the launch (``_median_time``), the card's cost of a
    launch that does almost no work.  This is the spec's ``op_startup_ns``."""
    device = resolve(device)
    x = torch.ones(2048, dtype=torch.float64, device=device)
    return _median_time(_k1("add"), (x, x, None), L2_REPEATS)


# kernels used to fit per-opcode factors and the HLO opcodes they exercise
# (the paper's per-OpClass latency table, fitted instead of NDA-supplied).
# Only *transcendental-class* opcodes are fitted; the arithmetic /
# conversion / numeric kernels are predicted purely by the bandwidth +
# vector-throughput model, so they genuinely test it (paper §5.1).
# The reference also fits "power" from pwr; no program reads that factor
# (pwr is exp(b*log(a)): log, exponential, multiply), so pwr is held out.
_FACTOR_FIT = {
    "exp": "exponential", "log": "log", "sin": "sine", "cos": "cosine",
    "atan": "atan2", "sqrt": "sqrt", "div": "divide",
}

# ----------------------------------------------- the CPU as a second test chip
def _cpu_timer(name: str, n: int, repeats: int) -> float:
    """Median seconds of the plain K1 ``name`` (``ops.elementwise`` on CPU
    tensors) over ``n`` elements after one warm-up: a Table-1 expression
    on its own inputs, ``poly16`` on |N(0, 1)| x 0.1 + 0.5 and ``fill`` on
    zeros, both f64.  Seeded from 0 per call."""
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    if name == "poly16":
        args = (torch.randn(n, generator=gen, dtype=torch.float64).abs()
                * 0.1 + 0.5, None, None)
    elif name == "fill":
        args = (torch.zeros(n, dtype=torch.float64), None, None)
    else:
        args = _kernel_inputs(KERNELS_BY_NAME[name], n, gen, cpu)
    return _median_time(_k1(name), args, repeats)


def measure_dispatch_overhead(timer: Callable = _cpu_timer) -> float:
    """Seconds of one call of the plain K1 ``add`` on 8 f64 elements on the
    CPU: the host's per-call cost (the reference's empty ``jax.jit``), the
    CPU spec's ``op_startup_ns``."""
    return timer("add", 8, 50)


def fit_cpu_host(n_mem: int = 1 << 21, n_fac: int = 1 << 15,
                 size_scale: int = SIZE_SCALE,
                 timer: Callable = _cpu_timer) -> HardwareSpec:
    """Fit the CPU host's HardwareSpec from the plain K1 functions in f64
    (torch on the CPU): the reference's ``fit_cpu_host``, its steps and
    formulas in its order, with the CPU as a second test chip beside the
    H100.  ``timer(name, n, repeats)`` gives the median seconds of the
    plain K1 ``name`` over ``n`` elements (:func:`_cpu_timer`; tests pass
    their own):

    * ``op_startup_ns`` — :func:`measure_dispatch_overhead`;
    * ``vpu_flops`` — ``poly16`` (32 flops an element) on an LLC-resident
      array, startup subtracted (f32 at twice the f64 rate);
    * ``vmem_bw`` (the LLC) — ``add`` on ``n_fac`` elements;
    * ``hbm_write_bw`` — ``fill`` (a pure store) on ``n_mem`` elements,
      and ``hbm_read_bw`` — ``add`` on ``n_mem`` with the fitted store
      time subtracted (the blended rate if nothing is left);
    * per-opcode factors of the ``_FACTOR_FIT`` kernels at Table 1's n x
      ``size_scale``, with the per-level stream time subtracted;
    * the hierarchy sanity clamp: the LLC is never slower than DRAM.
    """
    startup = measure_dispatch_overhead(timer)
    # --- ALU rate: Horner poly16, LLC-resident
    alu = 32.0 * n_fac / max(timer("poly16", n_fac, 25) - startup, 1e-9)
    # --- stream rates: LLC-resident and DRAM-resident add (3 streams)
    l2_bw = 3 * 8 * n_fac / max(timer("add", n_fac, 25) - startup, 1e-9)
    t_add_mem = timer("add", n_mem, REPEATS)
    blend_bw = 3 * 8 * n_mem / max(t_add_mem - startup, 1e-9)
    # --- DRAM store path: a pure fill isolates writes; the add stream then
    # yields the load path with the store time subtracted
    wr_bw = 8 * n_mem / max(timer("fill", n_mem, REPEATS) - startup, 1e-9)
    t_loads = t_add_mem - startup - 8 * n_mem / wr_bw
    rd_bw = (2 * 8 * n_mem / t_loads) if t_loads > 0 else blend_bw
    l2_bw = max(l2_bw, rd_bw, wr_bw)
    # --- per-opcode factors at the EVALUATION scale, stream time subtracted
    factors = {}
    for kname, opcode in _FACTOR_FIT.items():
        _, n_in, _, _ = EXPRS[kname]
        n_eval = KERNELS_BY_NAME[kname].n * size_scale
        t = timer(kname, n_eval, 9)
        t_mem = n_in * 8 * n_eval / rd_bw + 8 * n_eval / wr_bw
        factors[opcode] = max(1.0, (t - startup - t_mem) * alu / n_eval)
    # mod = divide + round-trip; remainder rides the divide entry
    factors.setdefault("remainder", factors.get("divide", 4.0))
    return CPU_HOST.with_(
        vpu_flops={"f64": alu, "f32": 2 * alu, "default": alu},
        peak_flops={"f64": alu, "f32": 2 * alu, "default": alu},
        transcendental_factor=max(2.0, factors.get("exponential", 4.0)),
        opcode_factor={**CPU_HOST.opcode_factor, **factors},
        hbm_read_bw=rd_bw,
        hbm_write_bw=wr_bw,
        vmem_bytes=24 * 2**20,      # LLC stand-in
        vmem_bw=l2_bw,
        # a CPU core stalls on the miss THEN computes: additive composition
        dma_overlap=0.0,
        op_startup_ns=startup * 1e9,
    )


# fit_h100's working sets: well inside the 50 MB L2 (3 x 8 MB for add) and
# at least 4x L2 in HBM (3 x 268 MB for add; 268 MB for fill, so that the
# stores the L2 still holds dirty when the launch ends are a small share).
# The L2-resident launches take a few µs, so their medians and the
# startup's are taken over many calls.
N_L2 = 1 << 20
N_HBM = 1 << 25
L2_REPEATS = 200


def fit_h100(device="cuda") -> HardwareSpec:
    """Fit the H100's HardwareSpec from K1 microbenchmarks on the card.

    The counterpart of the reference's ``fit_cpu_host``, with its steps and
    formulas in its order; each level and unit is fitted by a benchmark
    that isolates it:

    * ``op_startup_ns`` — one K1 launch on one block;
    * ``vpu_flops`` — K1 ``poly16`` (16 FMAs, 32 flops an element) on an
      L2-resident array, in f64 and in f32;
    * ``vmem_bw`` (the L2) — K1 ``add`` well inside L2;
    * ``hbm_write_bw`` — K1 ``fill`` (a pure store) in HBM, and
      ``hbm_read_bw`` — HBM-resident ``add`` (2 loads + 1 store, at least
      4x L2) with the fitted store time subtracted;
    * per-opcode factors of the ``_FACTOR_FIT`` kernels at the evaluation
      scale (Table 1's n x ``SIZE_SCALE``), with the per-level stream time
      subtracted (the paper's per-OpClass latency table);
    * the hierarchy sanity clamp: the L2 is never slower than HBM.

    The tensor-core rates (``peak_flops``) are the data sheet's.  Raises
    without a card unless ``device="cpu"`` (where it fits the CPU's
    numbers into an H100-shaped spec, for tests only).
    """
    device = resolve(device)
    gen = torch.Generator(device=device).manual_seed(0)
    startup = measure_launch_overhead(device)
    n_l2, n_mem = N_L2, N_HBM

    def t_kernel(name: str, n: int, repeats: int = REPEATS) -> float:
        x1, x2, y0 = _kernel_inputs(KERNELS_BY_NAME[name], n, gen, device)
        return _median_time(_k1(name), (x1, x2, y0), repeats)

    # --- ALU rate: Horner poly16, L2-resident, f64 and f32
    xp = torch.randn(n_l2, generator=gen, device=device,
                     dtype=torch.float64).abs() * 0.1 + 0.5
    alu = 32.0 * n_l2 / max(_median_time(_k1("poly16"), (xp, None, None),
                                         L2_REPEATS) - startup, 1e-9)
    alu32 = 32.0 * n_l2 / max(_median_time(_k1("poly16"),
                                           (xp.float(), None, None),
                                           L2_REPEATS) - startup, 1e-9)

    # --- stream rates: L2-resident and HBM-resident add (3 streams)
    t_add_l2 = t_kernel("add", n_l2, L2_REPEATS)
    l2_bw = 3 * 8 * n_l2 / max(t_add_l2 - startup, 1e-9)
    t_add_mem = t_kernel("add", n_mem)
    blend_bw = 3 * 8 * n_mem / max(t_add_mem - startup, 1e-9)

    # --- HBM store path: a pure fill isolates writes; the add stream then
    # yields the load path with the store time subtracted
    xm = torch.zeros(n_mem, dtype=torch.float64, device=device)
    t_fill = _median_time(_k1("fill"), (xm, None, None), 15)
    wr_bw = 8 * n_mem / max(t_fill - startup, 1e-9)
    t_loads = t_add_mem - startup - 8 * n_mem / wr_bw
    rd_bw = (2 * 8 * n_mem / t_loads) if t_loads > 0 else blend_bw
    # hierarchy sanity (the §12 monotonicity contract): an inner level is
    # never slower than the level it front-ends
    l2_bw = max(l2_bw, rd_bw, wr_bw)

    # --- per-opcode factors at the EVALUATION scale, stream time subtracted
    factors = {}
    for kname, opcode in _FACTOR_FIT.items():
        k = KERNELS_BY_NAME[kname]
        _, n_in, _, _ = EXPRS[kname]
        n_eval = k.n * SIZE_SCALE
        t = t_kernel(kname, n_eval, 9)
        t_mem = n_in * 8 * n_eval / rd_bw + 8 * n_eval / wr_bw
        factors[opcode] = max(1.0, (t - startup - t_mem) * alu / n_eval)
    # mod = divide + round-trip; remainder rides the divide entry
    factors.setdefault("remainder", factors.get("divide", 4.0))

    return H100.with_(
        vpu_flops={"f64": alu, "f32": alu32, "default": alu},
        transcendental_factor=max(2.0, factors.get("exponential", 4.0)),
        # fitted transcendental entries override the placeholder table; the
        # non-fitted entries (convert/round/...) survive
        opcode_factor={**H100.opcode_factor, **factors},
        hbm_read_bw=rd_bw,
        hbm_write_bw=wr_bw,
        vmem_bw=l2_bw,
        # the factor fit above subtracts the stream time from the measured
        # time, which inverts additive composition: compose the same way
        dma_overlap=0.0,
        op_startup_ns=startup * 1e9,
    )


@dataclass
class KernelRow:
    """One Table-1 kernel: measured time vs simulated estimates."""
    name: str
    ktype: str
    n: int
    measured_us: float
    simulated_us: float          # flat occupancy engine
    fit_input: bool = False      # this kernel informed the parameter fit
    simulated_sched_us: float = 0.0   # dependency-aware schedule engine
    bound_by: str = ""           # binding port of the occupancy engine

    @property
    def diff_pct(self) -> float:
        """Positive = simulator slower than test chip (paper convention)."""
        return 100.0 * (self.simulated_us - self.measured_us) / self.measured_us

    @property
    def sched_diff_pct(self) -> float:
        return 100.0 * (self.simulated_sched_us - self.measured_us) \
            / self.measured_us


@dataclass
class AccuracyTable:
    """Fig. 3-style accuracy summary over the kernel suite (paper §5)."""
    rows: List[KernelRow]
    # per-kernel programs, aligned with rows (kept when keep_programs=True
    # so sweep_o3 can re-schedule without re-measuring)
    programs: List[Program] = dataclasses.field(default_factory=list)

    @property
    def mean_diff(self) -> float:
        return statistics.mean(r.diff_pct for r in self.rows)

    @property
    def std_diff(self) -> float:
        return statistics.pstdev(r.diff_pct for r in self.rows)

    @property
    def mean_abs_diff(self) -> float:
        return statistics.mean(abs(r.diff_pct) for r in self.rows)

    @property
    def within_10pct(self) -> float:
        return sum(abs(r.diff_pct) <= 10.0 for r in self.rows) / len(self.rows)

    @property
    def sched_mean_abs_diff(self) -> float:
        return statistics.mean(abs(r.sched_diff_pct) for r in self.rows)

    @property
    def sched_within_10pct(self) -> float:
        return sum(abs(r.sched_diff_pct) <= 10.0
                   for r in self.rows) / len(self.rows)

    def report(self) -> str:
        lines = [f"{'kernel':<8s}{'type':<10s}{'n':>9s}{'measured_us':>13s}"
                 f"{'occup_us':>10s}{'diff%':>8s}{'sched_us':>10s}"
                 f"{'diff%':>8s}  fit?"]
        for r in self.rows:
            lines.append(f"{r.name:<8s}{r.ktype:<10s}{r.n:>9d}"
                         f"{r.measured_us:>13.2f}{r.simulated_us:>10.2f}"
                         f"{r.diff_pct:>8.1f}{r.simulated_sched_us:>10.2f}"
                         f"{r.sched_diff_pct:>8.1f}"
                         f"  {'*' if r.fit_input else ''}")
        lines.append(
            f"-- all {len(self.rows)} (occupancy):  mean {self.mean_diff:+.1f}%"
            f"  std {self.std_diff:.1f}%  mean|.| {self.mean_abs_diff:.1f}%  "
            f"within+-10%: {100 * self.within_10pct:.0f}%  "
            f"(paper: +1.3%, 7.8%, 6.6%, 82%)")
        lines.append(
            f"-- all {len(self.rows)} (schedule):   "
            f"mean|.| {self.sched_mean_abs_diff:.1f}%  "
            f"within+-10%: {100 * self.sched_within_10pct:.0f}%")
        held = [r for r in self.rows if not r.fit_input]
        if held and len(held) < len(self.rows):
            ho = AccuracyTable(held)
            lines.append(
                f"-- held-out ({len(held)}): mean {ho.mean_diff:+.1f}%  "
                f"std {ho.std_diff:.1f}%  mean|.| {ho.mean_abs_diff:.1f}%  "
                f"within+-10%: {100 * ho.within_10pct:.0f}%   "
                f"(* = parameter-fit inputs, as the paper's Fujitsu-"
                f"supplied latencies were)")
        return "\n".join(lines)


def kernel_accuracy_table(hw: Optional[HardwareSpec] = None,
                          size_scale: int = SIZE_SCALE,
                          kernels: Optional[List[Kernel]] = None,
                          keep_programs: bool = False,
                          device="cuda") -> AccuracyTable:
    """Time each Table-1 kernel's K1 launch (``ops.elementwise`` on
    ``device``, median of ``REPEATS`` after one warm-up) at Table 1's n x
    ``size_scale`` and hold it against ``simulate`` of the same launch's
    program (:func:`kernel_program`) on ``hw`` (default: ``fit_h100``),
    both engines, f64.  Inputs come from a ``torch.Generator`` seeded with
    0."""
    device = resolve(device)
    hw = hw or fit_h100(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows: List[KernelRow] = []
    programs: List[Program] = []
    for k in (kernels or KERNELS):
        n = k.n * size_scale
        x1, x2, y0 = _kernel_inputs(k, n, gen, device)
        t = _median_time(_k1(k.name), (x1, x2, y0))
        del x1, x2, y0
        prog = kernel_program(k.name, n)
        rep = simulate(prog, hw=hw, n_chips=1, compute_dtype="f64",
                       engine="both")
        rows.append(KernelRow(k.name, k.ktype, n, t * 1e6,
                              rep.engine.t_est * 1e6,
                              fit_input=k.name in _FACTOR_FIT,
                              simulated_sched_us=rep.schedule.t_est * 1e6,
                              bound_by=rep.engine.bound_by))
        if keep_programs:
            programs.append(prog)
    return AccuracyTable(rows, programs=programs)


# ------------------------------------------------------- O3 parameter sweep
# Sweep grid for the schedule engine's resource knobs — the paper's
# "detailed parameter tuning of out-of-order resources" (§4), fitted
# against the test chip instead of taken from Fujitsu's NDA tables.
O3_WINDOWS = (4, 16, 64, 256, 1024)
O3_MEM_WIDTHS = (1, 2, 4)
O3_VPU_WIDTHS = (1, 2)
O3_QUEUE_DEPTHS = (4, 16, 64)


def default_o3_knobs(hw: HardwareSpec, windows=O3_WINDOWS,
                     mem_widths=O3_MEM_WIDTHS, vpu_widths=O3_VPU_WIDTHS,
                     queue_depths=O3_QUEUE_DEPTHS):
    """The default batched O3 knob grid as a packed :class:`~.compiled.O3Knobs`:
    the (window x mem-width x vpu-width x queue-depth) product."""
    from .compiled import O3Knobs
    return O3Knobs.from_grid(hw, [(w, mw, vw, qd)
                                  for w in windows
                                  for mw in mem_widths
                                  for vw in vpu_widths
                                  for qd in queue_depths])


def _knob_spec(hw: HardwareSpec, w: int, mw: int, vw: int,
               qd: int) -> HardwareSpec:
    return hw.with_(
        inflight_window=w,
        issue_width={**hw.issue_width, "mem": mw, "vpu": vw},
        queue_depth={p: qd for p in ("mxu", "vpu", "mem", "ici")})


def sweep_o3(table: AccuracyTable, hw: HardwareSpec,
             windows=O3_WINDOWS, mem_widths=O3_MEM_WIDTHS,
             queue_depths=O3_QUEUE_DEPTHS, vpu_widths=O3_VPU_WIDTHS,
             compute_dtype: str = "f64", backend: str = "numpy",
             core_counts: Sequence[int] = (1,), topology=None,
             device="cuda") -> "O3Sweep":
    """Re-schedule already-measured programs under each knob combination
    (no re-measurement) and rank combos by mean |diff| of the schedule
    engine vs the measured times.

    The whole grid runs batched (``core.compiled.schedule_batch``): each
    program is compiled once to array form and one sequential pass per
    program advances all combos in lockstep.  ``backend="torch"`` runs
    each pass as the scan kernel on ``device`` (``kernels.sched_scan``),
    bit-identical to ``"numpy"``.

    ``core_counts`` adds the node engine's core count as a sweep axis:
    the counts above 1 ride one fused batch of the batched node engine
    (``core.node.schedule_node_sweep``, shard partition under
    ``topology``), which carries every knob combo through its own
    contention fixpoint.  Rows against single-core measurements are only
    comparable at ``n_cores=1``; ``best`` is picked among the smallest
    swept core count.  Requires a table built with ``keep_programs=True``.
    Returns an :class:`O3Sweep` (ranked results + the tuned
    ``HardwareSpec``)."""
    from .compiled import O3Knobs, compile_program, schedule_batch
    from .node import compile_node, schedule_node_sweep
    if not table.programs:
        raise ValueError("sweep_o3 needs kernel_accuracy_table("
                         "keep_programs=True)")
    import numpy as np
    combos = [(w, mw, vw, qd) for w in windows for mw in mem_widths
              for vw in vpu_widths for qd in queue_depths]
    knobs = O3Knobs.from_grid(hw, combos)
    core_counts = tuple(core_counts) or (1,)
    diffs = np.empty((len(table.programs), len(core_counts), knobs.batch))
    node_counts = sorted({k for k in core_counts if k > 1})
    for r, (prog, row) in enumerate(zip(table.programs, table.rows)):
        t_by_count = {}
        if 1 in core_counts:
            cp = compile_program(prog, hw, compute_dtype=compute_dtype)
            t_by_count[1] = schedule_batch(cp, knobs, backend=backend,
                                           device=device)
        if node_counts:
            sw = schedule_node_sweep(
                compile_node(prog, hw, compute_dtype=compute_dtype),
                hw, knobs, node_counts, topology, partition="shard",
                backend=backend, device=device)
            t_by_count.update(zip(node_counts, sw))
        for ci, n_cores in enumerate(core_counts):
            t_us = t_by_count[n_cores] * 1e6
            diffs[r, ci] = np.abs(t_us - row.measured_us) \
                / row.measured_us * 100.0
    mean_abs = diffs.mean(axis=0)
    within = (diffs <= 10.0).mean(axis=0)
    results: List[Dict] = []
    for ci, n_cores in enumerate(core_counts):
        for k, (w, mw, vw, qd) in enumerate(combos):
            results.append({"inflight_window": w, "mem_issue_width": mw,
                            "vpu_issue_width": vw, "queue_depth": qd,
                            "n_cores": n_cores,
                            "mean_abs_diff_pct": float(mean_abs[ci, k]),
                            "within_10pct": float(within[ci, k])})
    results.sort(key=lambda r: r["mean_abs_diff_pct"])
    min_cores = min(core_counts)
    best = next(r for r in results if r["n_cores"] == min_cores)
    tuned = _knob_spec(hw, best["inflight_window"], best["mem_issue_width"],
                       best["vpu_issue_width"], best["queue_depth"])
    return O3Sweep(results=results, best=tuned)


@dataclass
class O3Sweep:
    """Ranked results of one batched O3 knob sweep (paper §4 tuning)."""
    results: List[Dict]          # ranked best-first
    best: HardwareSpec           # hw with the winning O3 knobs applied

    def report(self, top: int = 8) -> str:
        lines = [f"{'window':>7s}{'mem_w':>7s}{'vpu_w':>7s}{'qdepth':>7s}"
                 f"{'cores':>7s}{'mean|.|%':>10s}{'<=10%':>7s}"]
        for r in self.results[:top]:
            lines.append(f"{r['inflight_window']:>7d}"
                         f"{r['mem_issue_width']:>7d}"
                         f"{r.get('vpu_issue_width', 1):>7d}"
                         f"{r['queue_depth']:>7d}"
                         f"{r.get('n_cores', 1):>7d}"
                         f"{r['mean_abs_diff_pct']:>10.1f}"
                         f"{100 * r['within_10pct']:>6.0f}%")
        return "\n".join(lines)


# ------------------------------------------------ Triad scaling (Figs. 4/5)
def triad_fit(nbytes: float, meas: Dict[int, float]):
    """The saturating-bandwidth model of ``benchmarks/triad.py`` fitted to
    measured seconds per CTA count: ``bw1`` from the first count, the
    ``plateau`` from the sweep's maximum, ``t_sim = bytes / min(k * bw1,
    plateau)``.  Returns (rows, {"bw1", "plateau"}) in bytes/s."""
    counts = list(meas)
    agg = {k: nbytes / t for k, t in meas.items()}
    bw1 = agg[counts[0]]
    plateau = max(agg.values())
    rows = []
    for k in counts:
        t_meas = meas[k]
        t_sim = nbytes / min(k * bw1, plateau)
        rows.append({"ctas": k, "measured_s": t_meas, "simulated_s": t_sim,
                     "measured_gbps": agg[k] / 1e9,
                     "simulated_gbps": nbytes / t_sim / 1e9,
                     "diff_pct": 100.0 * (t_sim - t_meas) / t_meas})
    return rows, {"bw1": bw1, "plateau": plateau}


def _graph_time(fn: Callable, args, repeats: int) -> float:
    """Seconds per call of ``fn(*args)`` on the card: CUDA events around one
    replay of a CUDA graph of ``repeats`` calls, after one eager warm-up.
    The device time alone, without the host's per-call cost (longer than a
    Triad launch at ¾ of the L2)."""
    fn(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn(*args)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) * 1e-3 / repeats


def triad_scaling(n_elems: int, sm_counts: Sequence[int],
                  repeats: int = REPEATS, device="cuda",
                  dtype: torch.dtype = torch.float64):
    """Figs. 4/5 on the card: K2 timed at each CTA cap in ``sm_counts`` (one
    1024-thread CTA per SM up to the cap), then :func:`triad_fit`.  The
    counterpart of ``benchmarks/triad.py``'s ``sweep``, whose host-thread
    count the CTA cap stands in for.  On the card each time is the device
    time of ``repeats`` launches replayed from a CUDA graph (one warm-up,
    then ``repeats`` launches: ``1 + repeats`` counted and run); on the CPU
    the host clock's median.  Returns (rows, fit)."""
    device = resolve(device)
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(n_elems, generator=gen, device=device, dtype=dtype)
    b = torch.randn(n_elems, generator=gen, device=device, dtype=dtype)
    nbytes = 3 * a.element_size() * n_elems       # 2 reads + 1 write
    timer = _graph_time if device.type == "cuda" else _median_time
    meas = {k: timer(
        lambda x, y, k=k: ops.stream_triad(x, y, 3.0, max_ctas=k), (a, b),
        repeats) for k in sm_counts}
    return triad_fit(nbytes, meas)
