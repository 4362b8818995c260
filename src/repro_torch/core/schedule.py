"""Dependency-aware O3 scheduling engine — overlap that *emerges*.

A copy of ``repro.core.schedule`` (no JAX; the port's tests hold it bit for bit
against the reference).

The flat occupancy engine (``core.engine``) assumes overlap: fixed
``dma_overlap`` / ``ici_overlap`` fractions of memory and collective time
hide under compute.  This module replaces the assumption with a schedule,
following gem5's issue/reservation-station design at HLO altitude:

* every costed op is a task on one port (MXU / VPU / DMA-mem / ICI) with a
  duration from the shared ``core.cost`` pipeline (hierarchy-routed memory
  times included),
* ``parse_program`` supplies def-use edges (``OpStat.deps``), so async-DMA
  and async-collective overlap falls out of the dataflow graph — an op
  waits for its producers, not for program order,
* three O3 resource knobs bound the reordering, the reservation-station /
  ROB analogue (``HardwareSpec``):
    - ``issue_width[port]``   parallel pipes per port,
    - ``inflight_window``     ROB size: op *i* cannot issue until op
                              *i - window* has retired (in-order retire),
    - ``queue_depth[port]``   per-port reservation-station depth: op *i*
                              cannot issue until the op ``depth`` earlier
                              on the same port has issued.

The scheduler is a deterministic in-order list scheduler: ops are visited
in (topological) program order and start at the max of their constraint
times.  Every constraint time is bounded by the worst finish seen so far,
which gives the engine's defining invariant, asserted in the golden tests:

    t_roofline  <=  t_est(schedule)  <=  t_serial

where ``t_roofline`` here is the schedule-consistent bound
``max_p busy_p / width_p`` and ``t_serial`` is the fully-serialized sum.

Two execution paths share those semantics (DESIGN.md §13):

* the **fast path** (default): ``core.compiled`` compiles the costed
  program to structure-of-arrays form once and runs an allocation-free
  kernel — ``t_est``/``port_busy``/``stall_by_reason`` only, bit-identical
  to the interpreter;
* the **reference interpreter** (``schedule_reference``): builds the full
  ``ScheduledOp`` timeline and binding-chain critical path.  The fast
  path's ``ScheduleResult`` materializes it lazily the first time
  ``timeline`` / ``critical_path`` is touched (i.e. when the PA report
  asks), so sweeps never pay for it.
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .cost import OpTime, cost_program
from .hlo import OpStat, Program
from .hwspec import HardwareSpec

# the binding-chain walk stops after this many entries; ScheduleResult
# raises the critical_path_truncated flag when the cap bites
CRITICAL_PATH_LIMIT = 256


@dataclass
class ScheduledOp:
    """One op placed on the timeline."""
    index: int                   # position in Program.ops
    op: OpStat
    port: str
    start: float
    finish: float
    ready: float                 # when all producers had finished
    bound_by: str                # what set the start time:
                                 #   'ready' | 'dep' | 'port' | 'window'
                                 #   | 'queue'
    bound_on: int = -1           # index of the op that imposed the bound

    @property
    def duration(self) -> float:
        return self.finish - self.start


@dataclass
class ScheduleResult:
    """Output of the dependency-aware O3 list scheduler (DESIGN.md §11).

    ``t_est`` always sits inside the sandwich ``max(t_roofline,
    t_dataflow) <= t_est <= t_serial`` (property-tested).  Timeline and
    critical-path detail are materialized lazily on first access when the
    result came from the compiled fast path (DESIGN.md §13); sweeps that
    only read ``t_est`` never pay for them.  The node engine
    (DESIGN.md §14) aggregates its per-core streams into one of these.
    """
    t_est: float                 # makespan of the schedule
    t_roofline: float            # max port busy / issue width (lower bound)
    t_serial: float              # fully serialized (upper bound)
    t_dataflow: float            # critical path, infinite resources
    port_busy: Dict[str, float]  # summed scheduled durations per port
    n_ops: float
    n_edges: int                 # def-use edges seen by the scheduler
    stall_by_reason: Dict[str, float] = field(default_factory=dict)
    issue_width: Dict[str, int] = field(default_factory=dict)
    # timeline/critical-path detail: populated eagerly by the reference
    # interpreter, lazily (via _detail) on the fast path
    _timeline: Optional[List[ScheduledOp]] = field(default=None, repr=False)
    _critical_path: Optional[List[ScheduledOp]] = field(default=None,
                                                        repr=False)
    _cp_truncated: bool = False
    _detail: Optional[Callable[[], "ScheduleResult"]] = field(default=None,
                                                              repr=False)

    def _ensure_detail(self) -> None:
        if self._timeline is None:
            if self._detail is None:
                self._timeline, self._critical_path = [], []
                return
            ref = self._detail()
            self._timeline = ref._timeline
            self._critical_path = ref._critical_path
            self._cp_truncated = ref._cp_truncated
            self._detail = None

    @property
    def timeline(self) -> List[ScheduledOp]:
        self._ensure_detail()
        return self._timeline

    @property
    def critical_path(self) -> List[ScheduledOp]:
        self._ensure_detail()
        return self._critical_path

    @property
    def critical_path_truncated(self) -> bool:
        """True when the binding-chain walk hit CRITICAL_PATH_LIMIT — the
        reported path is a suffix, not the whole chain."""
        self._ensure_detail()
        return self._cp_truncated

    @property
    def bound_by(self) -> str:
        """Binding port, normalized by issue width — consistent with how
        t_roofline picks it (raw busy would crown a 4-pipe DMA port over
        a busier single-pipe MXU)."""
        if not self.port_busy:
            return "mem"
        w = self.issue_width
        return max(self.port_busy,
                   key=lambda k: self.port_busy[k] / max(1, w.get(k, 1)))

    @property
    def overlap_fraction(self) -> float:
        """Fraction of serial time hidden by the schedule (0 = no overlap
        found, i.e. one dependence chain; -> (serial-est)/serial)."""
        if self.t_serial <= 0:
            return 0.0
        return max(0.0, (self.t_serial - self.t_est) / self.t_serial)


def _duration(ot: OpTime, hw: HardwareSpec) -> float:
    """Total task time: per-instance critical resource time + issue cost,
    times the (loop-trip) count.  Iterations of a collapsed while body are
    loop-carried, hence serial within the op."""
    per = max(ot.t_compute, ot.t_mem, ot.t_ici) + hw.op_startup_ns * 1e-9
    return per * ot.op.count


def _roofline(port_busy: Dict[str, float], widths: Dict[str, int]) -> float:
    return max((busy / max(1, widths.get(p, 1))
                for p, busy in port_busy.items()), default=0.0)


def schedule_program(prog: Program, hw: HardwareSpec,
                     links_per_collective: int = 2,
                     compute_dtype: Optional[str] = None,
                     costed: Optional[List[Optional[OpTime]]] = None,
                     detail: bool = False) -> ScheduleResult:
    """Schedule ``prog`` under ``hw``'s O3 knobs.

    Default is the compiled fast path (no ``ScheduledOp`` allocation);
    the timeline/critical-path detail is built on first access — pass
    ``detail=True`` to force the reference interpreter up front.
    """
    if detail:
        return schedule_reference(prog, hw, links_per_collective,
                                  compute_dtype, costed)
    from .compiled import compile_program, schedule_arrays
    cp = compile_program(prog, hw, links_per_collective, compute_dtype,
                         costed=costed)
    t_est, stall = schedule_arrays(cp, hw)
    return ScheduleResult(
        t_est=t_est,
        t_roofline=_roofline(cp.port_busy, hw.issue_width),
        t_serial=cp.t_serial,
        t_dataflow=cp.t_dataflow,
        port_busy=dict(cp.port_busy),
        n_ops=cp.n_ops,
        n_edges=cp.n_edges,
        stall_by_reason=stall,
        issue_width=dict(hw.issue_width),
        _detail=lambda: schedule_reference(prog, hw, links_per_collective,
                                           compute_dtype, costed),
    )


def schedule_reference(prog: Program, hw: HardwareSpec,
                       links_per_collective: int = 2,
                       compute_dtype: Optional[str] = None,
                       costed: Optional[List[Optional[OpTime]]] = None
                       ) -> ScheduleResult:
    """The per-op interpreter: same schedule as the fast path, plus the
    full timeline and binding-chain critical path.  The differential tests
    pin the fast path's ``t_est``/``port_busy``/stalls to this."""
    n = len(prog.ops)
    if costed is None:
        costed = cost_program(prog, hw, links_per_collective, compute_dtype)

    widths = hw.issue_width
    depths = hw.queue_depth
    window = max(1, hw.inflight_window)

    # port -> heap of (pipe_free_time, op_that_freed_it)
    pipes: Dict[str, List[Tuple[float, int]]] = {}
    port_hist: Dict[str, List[int]] = defaultdict(list)   # issued, per port
    finishes = [0.0] * n
    # in-order retirement: rtime[i] = time op i leaves the ROB, and the op
    # whose finish dominates it (for critical-path attribution)
    rtime: List[float] = []
    rtime_argmax: List[int] = []

    timeline: List[ScheduledOp] = []
    sched_of: Dict[int, ScheduledOp] = {}
    port_busy: Dict[str, float] = defaultdict(float)
    t_serial = 0.0
    n_ops = 0.0
    n_edges = 0
    stall: Dict[str, float] = defaultdict(float)

    for i, ot in enumerate(costed):
        if ot is None:
            # free op: propagate readiness through it at zero cost
            t_dep = max((finishes[j] for j in prog.ops[i].deps
                         if 0 <= j < i), default=0.0)
            finishes[i] = t_dep
            rtime.append(max(rtime[-1] if rtime else 0.0, t_dep))
            rtime_argmax.append(rtime_argmax[-1] if rtime_argmax else -1)
            continue
        o = ot.op
        dur = _duration(ot, hw)
        port = ot.port
        width = max(1, widths.get(port, 1))
        depth = max(1, depths.get(port, 1))
        if port not in pipes:
            pipes[port] = [(0.0, -1)] * width
            heapq.heapify(pipes[port])

        # --- constraint times
        ready, dep_src = 0.0, -1
        for j in o.deps:
            if 0 <= j < i:
                n_edges += 1
                if finishes[j] > ready:
                    ready, dep_src = finishes[j], j
        pipe_free, pipe_src = pipes[port][0]
        win_t, win_src = 0.0, -1
        if i >= window:
            win_t, win_src = rtime[i - window], rtime_argmax[i - window]
        q_t, q_src = 0.0, -1
        hist = port_hist[port]
        if len(hist) >= depth:
            q_src = hist[-depth]
            q_t = sched_of[q_src].start
        start, bound_by, bound_on = ready, ("dep" if dep_src >= 0
                                            else "ready"), dep_src
        for t, why, src in ((pipe_free, "port", pipe_src),
                            (win_t, "window", win_src),
                            (q_t, "queue", q_src)):
            if t > start:
                start, bound_by, bound_on = t, why, src
        finish = start + dur

        heapq.heapreplace(pipes[port], (finish, i))
        hist.append(i)
        finishes[i] = finish
        rt = max(rtime[-1] if rtime else 0.0, finish)
        rtime.append(rt)
        rtime_argmax.append(i if rt == finish else rtime_argmax[-1])

        s = ScheduledOp(i, o, port, start, finish, ready, bound_by, bound_on)
        sched_of[i] = s
        timeline.append(s)
        port_busy[port] += dur
        t_serial += dur
        n_ops += o.count
        if start > ready:
            stall[bound_by] += start - ready

    t_est = max((s.finish for s in timeline), default=0.0)

    # --- pure dataflow critical path (infinite resources lower bound)
    length = [0.0] * n
    for i, ot in enumerate(costed):
        d = _duration(ot, hw) if ot is not None else 0.0
        length[i] = d + max((length[j] for j in prog.ops[i].deps
                             if 0 <= j < i), default=0.0)
    t_dataflow = max(length, default=0.0)

    # --- walk the binding chain back from the makespan op
    critical: List[ScheduledOp] = []
    truncated = False
    if timeline:
        cur = max(timeline, key=lambda s: s.finish)
        seen = set()
        while cur is not None and cur.index not in seen:
            if len(critical) >= CRITICAL_PATH_LIMIT:
                truncated = True
                break
            seen.add(cur.index)
            critical.append(cur)
            cur = sched_of.get(cur.bound_on)
        critical.reverse()

    return ScheduleResult(
        t_est=t_est,
        t_roofline=_roofline(port_busy, widths),
        t_serial=t_serial,
        t_dataflow=t_dataflow,
        port_busy=dict(port_busy),
        n_ops=n_ops,
        n_edges=n_edges,
        stall_by_reason=dict(stall),
        issue_width=dict(widths),
        _timeline=timeline,
        _critical_path=critical,
        _cp_truncated=truncated,
    )
