"""SimPoint-style sampled estimation — schedule ~10% of a long program.

A copy of ``repro.core.sample``, held bit for bit against it.  Two
changes: ``sampled_node_sweep`` takes ``backend="torch"`` (each
representative's sweep runs the batched node engine's passes through the
scan kernel on ``device``, ``kernels.sched_scan``) where the reference
takes ``"jax"``; and every program this module builds (intervals, unrolled
traces) keeps its source's ``exact_dtypes``, so an ATen capture
(``core.aten``) is costed at its real dtypes in every slice.  The feature
arrays take their level names from ``hw.memory_hierarchy()``, the levels
the cost model routes to: the reference reads ``hw.mem_levels``, which is
empty for a spec with only boundary scalars (``H100``, ``TPU_V5E``,
``CPU_HOST``), and raises ``KeyError`` there.

A captured ATen graph is eager and unrolled: every op has ``count`` 1, so
:func:`phase_boundaries` finds no boundary in it and intervals are cut by
instance count alone.

Long programs (full-depth training steps, token-by-token decode traces)
repeat near-identical iterations; scheduling every op through the node
engine's in-order pass wastes a wall-clock factor proportional to the
repetition.  This module is the gem5-lineage answer (SimPoint/LoopPoint
checkpoint sampling) at HLO altitude (DESIGN.md §18):

1. **Slice** — the costed :class:`~.hlo.Program` is cut into intervals of
   ~``interval_ops`` op *instances* (``OpStat.count``-weighted, so a
   collapsed 96-trip loop body weighs 96x its list length), with cuts
   snapped to *phase boundaries* — indices where the collapsed-loop
   ``count`` changes, i.e. entry/exit of a scanned layer stack — so an
   interval never straddles a loop edge when a boundary is near.
2. **Featurize** — each interval gets an op-mix/traffic signature built
   from the SAME arrays the node engine schedules (``NodeCompiled``):
   instance-weighted opclass histogram, per-port duration pressure,
   compute/ICI time, and per-level routed read+write bytes from
   ``memory.route_program``'s residency split.  Columns are max-scaled so
   no unit dominates the distance metric.
3. **Cluster** — deterministic seeded k-means (numpy; farthest-point++
   init off a fixed ``numpy.random.RandomState``), k chosen by a
   BIC-style elbow (smallest k whose score reaches ``bic_frac`` of the
   best over 1..max_k) unless pinned.
4. **Schedule only representatives** — the member nearest each centroid
   runs through the node engine (``schedule_node`` scalar, or the fused
   ``schedule_node_sweep`` core-count x knob grid); every other interval
   is never scheduled.
5. **Reconstruct** — ``t_est = sum_c w_c * t(rep_c)`` with
   ``w_c = cluster instances / rep instances``; per-level traffic and the
   binding port blend the same way.

**Warm-up handling**: the program is costed ONCE, whole — reuse
distances and residency levels come from ``route_program`` over the
*full* op sequence, and each interval is scheduled on a slice of that
costed list.  An interval's boundary reads therefore keep the residency
the full trace gave them (data produced by the preceding interval is
still level-resident); re-routing intervals standalone would charge
those as cold misses twice — once in the producing interval's writes and
once at the consumer — which is exactly the double-count this avoids.

**Exactness anchor**: scheduling an interval in isolation replays the
full in-order pass between barriers — every pre-boundary constraint
(dep finishes, pipe lanes, ROB retire ring, queue history) is dominated
by the preceding intervals' makespan, so the sum over ALL intervals
equals the barriered full pass.  ``k >= n_intervals`` short-circuits to
one-cluster-per-interval and is therefore bit-identical to that full
interval scheduling (pinned by ``tests/test_sampling.py``); the residual
vs the *monolithic* (barrier-free) pass is the cross-boundary overlap
the ROB window spans, a few percent for intervals >> window (pinned at
5% on the suite programs).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .compiled import PORTS
from .cost import OpTime, cost_program
from .hlo import OpStat, Program
from .hwspec import HardwareSpec, NodeTopology
from .node import NodeCompiled, compile_node, schedule_node, \
    schedule_node_sweep

#: opclass axis of the signature vector (stable order)
OPCLASSES: Tuple[str, ...] = ("matmul", "elementwise", "transcendental",
                              "reduce", "data", "collective")


@dataclass(frozen=True)
class SamplingConfig:
    """Knobs of the sampled estimator (DESIGN.md §18).

    ``interval_ops`` is the target op-*instance* count per interval
    (``OpStat.count``-weighted).  ``k=None`` selects k by the BIC-style
    elbow over ``1..max_k``; ``k >= n_intervals`` degenerates to exact
    full interval scheduling.  Everything is deterministic for a fixed
    ``seed``.
    """
    interval_ops: float = 512.0
    k: Optional[int] = None
    max_k: int = 16
    seed: int = 0
    bic_frac: float = 0.9
    phase_aware: bool = True
    #: snap radius for phase-boundary cuts, as a fraction of interval_ops
    snap_frac: float = 0.25


@dataclass
class Interval:
    """One contiguous op range ``[start, end)`` of the sliced program."""
    start: int
    end: int
    n_instances: float           # sum of OpStat.count over the range


@dataclass
class SamplePlan:
    """The sampling decision for one (program, spec, dtype) cell:
    intervals, signatures, cluster assignment, representatives and
    weights — everything downstream scheduling needs, with the costed
    slices already attached (full-program routing, DESIGN.md §18)."""
    config: SamplingConfig
    intervals: List[Interval]
    signatures: np.ndarray       # [n_intervals, d] scaled feature rows
    labels: np.ndarray           # [n_intervals] cluster id
    reps: np.ndarray             # [k] interval index of each representative
    weights: np.ndarray          # [k] cluster instances / rep instances
    k: int
    n_ops: int                   # list ops in the program
    n_instances: float           # total op instances
    # sub-programs + costed slices for the representative intervals only
    rep_programs: List[Program] = field(default_factory=list, repr=False)
    rep_costed: List[List[Optional[OpTime]]] = field(
        default_factory=list, repr=False)

    @property
    def n_intervals(self) -> int:
        return len(self.intervals)

    @property
    def scheduled_ops(self) -> int:
        """List ops actually scheduled (the representatives')."""
        return sum(self.intervals[int(r)].end - self.intervals[int(r)].start
                   for r in self.reps)

    @property
    def scheduled_instances(self) -> float:
        return float(sum(self.intervals[int(r)].n_instances
                         for r in self.reps))

    @property
    def frac_ops_scheduled(self) -> float:
        """Fraction of op instances scheduled — the sampling cost knob
        (<= 0.2 at the CI floor)."""
        return self.scheduled_instances / max(self.n_instances, 1e-30)


@dataclass
class SampledNodeResult:
    """Weight-blended reconstruction of a node estimate from the
    representative intervals (the sampled counterpart of
    :class:`~.node.NodeResult`; DESIGN.md §18)."""
    t_est: float
    n_cores: int
    partition: str
    plan: SamplePlan
    t_rep: np.ndarray            # [k] representative interval makespans
    traffic_by_level: Dict[str, Dict[str, float]]
    port_busy: Dict[str, float]
    bound_by: str
    t_zero_contention: float
    # exact blend: sum_c w_c busy_c / (cores * sum_c w_c t_c)
    parallel_efficiency: float = 0.0

    @property
    def frac_ops_scheduled(self) -> float:
        return self.plan.frac_ops_scheduled


# ------------------------------------------------------------------ slicing
def phase_boundaries(prog: Program) -> np.ndarray:
    """Indices where the collapsed-loop ``count`` changes between
    adjacent ops — entry/exit points of scanned layer stacks, the
    natural phase edges of an XLA program."""
    counts = np.array([o.count for o in prog.ops], dtype=np.float64)
    if len(counts) < 2:
        return np.zeros(0, dtype=np.intp)
    return np.nonzero(counts[1:] != counts[:-1])[0] + 1


def slice_intervals(prog: Program, interval_ops: float,
                    phase_aware: bool = True,
                    snap_frac: float = 0.25) -> List[Interval]:
    """Cut the program into contiguous intervals of ~``interval_ops``
    instances.  With ``phase_aware`` the nominal cut snaps to the nearest
    phase boundary within ``snap_frac * interval_ops`` instances, so
    intervals don't straddle a loop edge when one is near."""
    n = len(prog.ops)
    if n == 0:
        return []
    counts = np.array([o.count for o in prog.ops], dtype=np.float64)
    cum = np.concatenate(([0.0], np.cumsum(counts)))   # cum[i] = before op i
    total = cum[-1]
    step = max(float(interval_ops), 1.0)
    bounds = set(phase_boundaries(prog).tolist()) if phase_aware else set()
    out: List[Interval] = []
    start = 0
    while start < n:
        target = cum[start] + step
        if target >= total:
            end = n
        else:
            # first index whose cumulative start reaches the target
            end = int(np.searchsorted(cum, target, side="left"))
            end = max(start + 1, min(end, n))
            if bounds:
                lo, hi = cum[end] - snap_frac * step, cum[end] + snap_frac * step
                near = [b for b in bounds
                        if start < b < n and lo <= cum[b] <= hi]
                if near:
                    end = min(near, key=lambda b: abs(cum[b] - cum[end]))
        out.append(Interval(start, end, float(cum[end] - cum[start])))
        start = end
    return out


# --------------------------------------------------------------- signatures
@dataclass
class _FeatureArrays:
    """Per-op arrays pulled straight from the costed list — the lean
    extraction (no full-program ``compile_node``; it would dominate the
    sampled wall on long traces)."""
    count: np.ndarray            # [n] instances per list op
    cls: np.ndarray              # [n] OPCLASSES index
    port: np.ndarray             # [n] PORTS index, -1 = uncosted
    dur: np.ndarray              # [n] per-instance op time (max of ports)
    t_comp: np.ndarray           # [n] per-instance compute time
    t_ici: np.ndarray            # [n] per-instance ICI time
    rdwr: np.ndarray             # [n, L] per-instance routed read+write B
    level_names: Tuple[str, ...]


def _feature_arrays(prog: Program, hw: HardwareSpec,
                    costed: Sequence[Optional[OpTime]]) -> _FeatureArrays:
    n = len(prog.ops)
    names = tuple(lv.name for lv in hw.memory_hierarchy())
    lvl = {nm: i for i, nm in enumerate(names)}
    cls_id = {c: i for i, c in enumerate(OPCLASSES)}
    pid = {p: i for i, p in enumerate(PORTS)}
    count = np.empty(n)
    cls = np.empty(n, dtype=np.intp)
    port = np.full(n, -1, dtype=np.intp)
    dur = np.zeros(n)
    t_comp = np.zeros(n)
    t_ici = np.zeros(n)
    rdwr = np.zeros((n, len(names)))
    for i, o in enumerate(prog.ops):
        count[i] = o.count
        cls[i] = cls_id.get(o.opclass, 1)
        ot = costed[i]
        if ot is None:
            continue
        port[i] = pid.get(ot.port, -1)
        dur[i] = ot.t_op
        t_comp[i] = ot.t_compute
        t_ici[i] = ot.t_ici
        tr = ot.traffic
        if tr is not None:
            row = rdwr[i]
            for nm, b in tr.read_by_level.items():
                row[lvl[nm]] += b
            for nm, b in tr.write_by_level.items():
                row[lvl[nm]] += b
    return _FeatureArrays(count, cls, port, dur, t_comp, t_ici, rdwr, names)


def interval_signatures(fa: _FeatureArrays,
                        intervals: Sequence[Interval]) -> np.ndarray:
    """Per-interval op-mix/traffic signature matrix, max-scaled columns.

    Features (all per-instance-normalized so interval length drops out
    and only the *mix* clusters): opclass histogram, per-port duration
    pressure, compute/ICI time, per-level routed read+write bytes."""
    n_iv = len(intervals)
    L = fa.rdwr.shape[1]
    d = len(OPCLASSES) + len(PORTS) + 2 + L
    X = np.zeros((n_iv, d))
    for ii, iv in enumerate(intervals):
        s, e = iv.start, iv.end
        inst = max(iv.n_instances, 1e-30)
        c = fa.count[s:e]
        row = X[ii]
        np.add.at(row, fa.cls[s:e], c)
        row[:len(OPCLASSES)] /= inst
        pm = fa.port[s:e]
        live = pm >= 0
        np.add.at(row, len(OPCLASSES) + pm[live],
                  (fa.dur[s:e] * c)[live])
        row[len(OPCLASSES):len(OPCLASSES) + len(PORTS)] /= inst
        off = len(OPCLASSES) + len(PORTS)
        row[off] = float((fa.t_comp[s:e] * c).sum()) / inst
        row[off + 1] = float((fa.t_ici[s:e] * c).sum()) / inst
        row[off + 2:] = (fa.rdwr[s:e] * c[:, None]).sum(axis=0) / inst
    scale = np.abs(X).max(axis=0)
    scale[scale <= 0] = 1.0
    return X / scale


# ------------------------------------------------------------------ k-means
def kmeans(X: np.ndarray, k: int, seed: int = 0,
           n_iter: int = 64) -> Tuple[np.ndarray, np.ndarray, float]:
    """Deterministic seeded Lloyd k-means with farthest-point++ init.
    Returns ``(labels, centers, wcss)``.  Empty clusters are reseeded to
    the point farthest from its center (keeps k populated when k <= the
    number of distinct rows)."""
    n = len(X)
    k = max(1, min(k, n))
    rng = np.random.RandomState(seed)
    centers = np.empty((k, X.shape[1]))
    centers[0] = X[int(rng.randint(n))]
    d2 = ((X - centers[0]) ** 2).sum(axis=1)
    for c in range(1, k):
        centers[c] = X[int(d2.argmax())]
        d2 = np.minimum(d2, ((X - centers[c]) ** 2).sum(axis=1))
    labels = np.zeros(n, dtype=np.intp)
    for _ in range(n_iter):
        dist = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
        new = dist.argmin(axis=1)
        for c in range(k):
            sel = new == c
            if sel.any():
                centers[c] = X[sel].mean(axis=0)
            else:
                far = int(dist[np.arange(n), new].argmax())
                centers[c] = X[far]
                new[far] = c
        if (new == labels).all():
            labels = new
            break
        labels = new
    wcss = float(((X - centers[labels]) ** 2).sum())
    return labels, centers, wcss


def choose_k(X: np.ndarray, max_k: int, seed: int = 0,
             bic_frac: float = 0.9) -> Tuple[int, np.ndarray, np.ndarray]:
    """SimPoint's k selection: score each k in ``1..max_k`` with a
    BIC-style criterion (spherical-Gaussian log-likelihood minus a
    ``k``-proportional complexity penalty) and keep the smallest k whose
    score reaches ``bic_frac`` of the best.  Returns ``(k, labels,
    centers)``."""
    n, d = X.shape
    best: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
    scores: Dict[int, float] = {}
    for k in range(1, min(max_k, n) + 1):
        labels, centers, wcss = kmeans(X, k, seed)
        var = wcss / max(n * d, 1)
        loglik = -0.5 * n * d * np.log(var + 1e-12)
        scores[k] = float(loglik - 0.5 * k * (d + 1) * np.log(max(n, 2)))
        best[k] = (labels, centers, wcss)
    top = max(scores.values())
    lo = min(scores.values())
    cut = lo + bic_frac * (top - lo)
    for k in sorted(scores):
        if scores[k] >= cut:
            labels, centers, _ = best[k]
            return k, labels, centers
    k = max(scores, key=scores.__getitem__)
    labels, centers, _ = best[k]
    return k, labels, centers


# ------------------------------------------------------------ sub-programs
def _like(prog: Program, ops: List[OpStat], entry: str) -> Program:
    """A program of ``ops`` with ``prog``'s partitions and dtype rule."""
    out = Program(ops=ops, entry=entry, n_partitions=prog.n_partitions)
    if prog.exact_dtypes:
        out.exact_dtypes = True
    return out


def _sub_program(prog: Program, costed: Sequence[Optional[OpTime]],
                 iv: Interval) -> Tuple[Program, List[Optional[OpTime]]]:
    """Slice ``[start, end)`` into a standalone Program + costed list.
    Deps are remapped into the interval; cross-boundary edges drop (their
    producers' finishes are dominated by the preceding intervals'
    makespan — the barrier argument in the module docstring).  The costed
    slice is reused as-is: durations keep the FULL-program routing."""
    s, e = iv.start, iv.end
    ops: List[OpStat] = []
    for i in range(s, e):
        o = prog.ops[i]
        if o.deps and (o.deps[0] < s or o.deps[-1] >= e):
            deps, dep_b = [], []
            for j, b in zip(o.deps, o.dep_bytes):
                if s <= j < e:
                    deps.append(j - s)
                    dep_b.append(b)
            o = dataclasses.replace(o, deps=deps, dep_bytes=dep_b)
        elif o.deps:
            o = dataclasses.replace(o, deps=[j - s for j in o.deps],
                                    dep_bytes=list(o.dep_bytes))
        ops.append(o)
    sub = _like(prog, ops, f"{prog.entry}[{s}:{e}]")
    return sub, list(costed[s:e])


# ------------------------------------------------------------------ the plan
def sample_program(prog: Program, hw: HardwareSpec,
                   config: Optional[SamplingConfig] = None,
                   compute_dtype: Optional[str] = None,
                   costed: Optional[List[Optional[OpTime]]] = None
                   ) -> SamplePlan:
    """Slice + featurize + cluster one costed program into a
    :class:`SamplePlan`.  The program is costed once, whole (full-trace
    reuse distances — the warm-up rule); representatives carry slices of
    that costed list."""
    config = config or SamplingConfig()
    if costed is None:
        costed = cost_program(prog, hw, compute_dtype=compute_dtype)
    fa = _feature_arrays(prog, hw, costed)
    intervals = slice_intervals(prog, config.interval_ops,
                                config.phase_aware, config.snap_frac)
    n_iv = len(intervals)
    X = interval_signatures(fa, intervals)
    if n_iv == 0:
        labels = np.zeros(0, dtype=np.intp)
        k = 0
    elif config.k is not None and config.k >= n_iv:
        # exact mode: every interval its own cluster (identity assignment
        # sidesteps k-means degeneracy on duplicate signatures)
        k = n_iv
        labels = np.arange(n_iv, dtype=np.intp)
    elif config.k is not None:
        k = max(1, config.k)
        labels, _, _ = kmeans(X, k, config.seed)
        k = int(labels.max()) + 1 if n_iv else 0
    else:
        k, labels, _ = choose_k(X, min(config.max_k, n_iv), config.seed,
                                config.bic_frac)

    inst = np.array([iv.n_instances for iv in intervals])
    reps = np.zeros(k, dtype=np.intp)
    weights = np.zeros(k)
    for c in range(k):
        members = np.nonzero(labels == c)[0]
        centroid = X[members].mean(axis=0)
        d2 = ((X[members] - centroid) ** 2).sum(axis=1)
        rep = int(members[int(d2.argmin())])
        reps[c] = rep
        weights[c] = inst[members].sum() / max(inst[rep], 1e-30)

    plan = SamplePlan(config=config, intervals=intervals, signatures=X,
                      labels=labels, reps=reps, weights=weights, k=k,
                      n_ops=len(prog.ops), n_instances=float(inst.sum()))
    for r in reps:
        sub, sub_costed = _sub_program(prog, costed, intervals[int(r)])
        plan.rep_programs.append(sub)
        plan.rep_costed.append(sub_costed)
    return plan


# --------------------------------------------------------------- estimation
def _rep_node_forms(plan: SamplePlan, hw: HardwareSpec,
                    compute_dtype: Optional[str]) -> List[NodeCompiled]:
    return [compile_node(sub, hw, compute_dtype=compute_dtype, costed=ct)
            for sub, ct in zip(plan.rep_programs, plan.rep_costed)]


def sampled_schedule_node(prog: Program, hw: HardwareSpec, n_cores: int,
                          topology: Optional[NodeTopology] = None,
                          partition: str = "shard",
                          config: Optional[SamplingConfig] = None,
                          compute_dtype: Optional[str] = None,
                          costed: Optional[List[Optional[OpTime]]] = None,
                          plan: Optional[SamplePlan] = None,
                          **kw) -> SampledNodeResult:
    """Sampled node estimate at one core count: schedule each cluster's
    representative through :func:`~.node.schedule_node` and blend by the
    instance weights.  A precomputed ``plan`` (e.g. shared across a
    core-count sweep) skips re-clustering."""
    if plan is None:
        plan = sample_program(prog, hw, config, compute_dtype, costed)
    forms = _rep_node_forms(plan, hw, compute_dtype)
    t_rep = np.zeros(plan.k)
    t_zero = busy = 0.0
    port_busy: Dict[str, float] = {}
    traffic: Dict[str, Dict[str, float]] = {}
    for c, nc in enumerate(forms):
        nr = schedule_node(nc, hw, n_cores, topology=topology,
                           partition=partition, **kw)
        w = plan.weights[c]
        t_rep[c] = nr.t_est
        t_zero += w * nr.t_zero_contention
        # busy-time blend => exact reconstructed parallel efficiency
        busy += w * nr.parallel_efficiency * n_cores * nr.t_est
        for p, b in nr.schedule.port_busy.items():
            port_busy[p] = port_busy.get(p, 0.0) + w * b
        # per-level routed bytes of the representative, weight-blended
        rd = (nc.rd * nc.count[:, None]).sum(axis=0)
        wr = (nc.wr * nc.count[:, None]).sum(axis=0)
        for li, nm in enumerate(nc.level_names):
            t = traffic.setdefault(nm, {"read_bytes": 0.0,
                                        "write_bytes": 0.0})
            t["read_bytes"] += w * float(rd[li])
            t["write_bytes"] += w * float(wr[li])
    bound = max(port_busy, key=port_busy.__getitem__) if port_busy else ""
    t_est = float((plan.weights * t_rep).sum())
    return SampledNodeResult(
        t_est=t_est, n_cores=n_cores,
        partition=partition, plan=plan, t_rep=t_rep,
        traffic_by_level=traffic, port_busy=port_busy, bound_by=bound,
        t_zero_contention=t_zero,
        parallel_efficiency=busy / max(n_cores * t_est, 1e-30))


def sampled_node_sweep(prog: Program, hw: HardwareSpec, knobs,
                       core_counts: Sequence[int],
                       topology: Optional[NodeTopology] = None,
                       partition: str = "shard",
                       config: Optional[SamplingConfig] = None,
                       compute_dtype: Optional[str] = None,
                       costed: Optional[List[Optional[OpTime]]] = None,
                       plan: Optional[SamplePlan] = None,
                       backend: str = "numpy", device="cuda"
                       ) -> Tuple[np.ndarray, SamplePlan]:
    """Sampled core-count x knob sweep: each representative rides the
    batched node engine (``schedule_node_sweep``), and the ``[C, B]``
    grids blend by the instance weights — the zoo's sampled path.
    ``backend="torch"`` runs every pass on ``device`` (the scan kernel on
    a card, its plain version on the CPU), bit-identical to ``"numpy"``."""
    if plan is None:
        plan = sample_program(prog, hw, config, compute_dtype, costed)
    core_counts = list(core_counts)
    out = np.zeros((len(core_counts), knobs.batch))
    for c, nc in enumerate(_rep_node_forms(plan, hw, compute_dtype)):
        t = schedule_node_sweep(nc, hw, knobs, core_counts,
                                topology=topology, partition=partition,
                                backend=backend, device=device)
        out += plan.weights[c] * t
    return out, plan


def full_interval_estimate(prog: Program, hw: HardwareSpec, n_cores: int,
                           topology: Optional[NodeTopology] = None,
                           partition: str = "shard",
                           config: Optional[SamplingConfig] = None,
                           compute_dtype: Optional[str] = None,
                           costed: Optional[List[Optional[OpTime]]] = None
                           ) -> SampledNodeResult:
    """The sampler's exact-coverage baseline: EVERY interval scheduled
    (k = n_intervals), no clustering error — what ``k >= n_intervals``
    sampling must reproduce bit-for-bit (differential tests)."""
    config = dataclasses.replace(config or SamplingConfig(), k=10 ** 9)
    return sampled_schedule_node(prog, hw, n_cores, topology, partition,
                                 config, compute_dtype, costed)


# ------------------------------------------------------------- long traces
def unroll_program(prog: Program, repeats: int,
                   chain: bool = True) -> Program:
    """Concatenate ``repeats`` copies of ``prog`` into one long trace —
    the zoo's full-depth/multi-step mode (a traced step of a
    layer-homogeneous stack repeats; decode emits one near-identical
    program per generated token).  Deps shift per copy; with ``chain``,
    each copy's source ops (no in-step producers) additionally wait on
    the previous copy's dataflow sinks through zero-byte edges — pure
    scheduling order, no phantom traffic (``route_program`` ignores
    zero-byte edges, so routing per copy matches the single step)."""
    n = len(prog.ops)
    if repeats <= 1 or n == 0:
        return prog
    consumed = set()
    for o in prog.ops:
        consumed.update(o.deps)
    sinks = [i for i in range(n) if i not in consumed] if chain else []
    ops: List[OpStat] = []
    for r in range(repeats):
        off = r * n
        for i, o in enumerate(prog.ops):
            deps = [j + off for j in o.deps]
            dep_b = list(o.dep_bytes)
            if chain and r > 0 and not o.deps:
                prev = (r - 1) * n
                deps = [s + prev for s in sinks]
                dep_b = [0.0] * len(sinks)
            ops.append(dataclasses.replace(o, deps=deps, dep_bytes=dep_b))
    return _like(prog, ops, f"{prog.entry}x{repeats}")


# ------------------------------------------------------- bench measurement
def measure_sampled_vs_full(prog: Program, hw: HardwareSpec, n_cores: int,
                            topology: Optional[NodeTopology] = None,
                            partition: str = "shard",
                            config: Optional[SamplingConfig] = None,
                            compute_dtype: Optional[str] = None) -> dict:
    """One benchmark row: monolithic full schedule vs sampled
    reconstruction — t_est error, fraction of op instances scheduled,
    end-to-end wall-clock speedup (costing excluded from both sides; it
    is shared).  ``benchmarks/sampled_estimation.py`` drives this."""
    costed = cost_program(prog, hw, compute_dtype=compute_dtype)

    t0 = time.perf_counter()
    nc = compile_node(prog, hw, compute_dtype=compute_dtype, costed=costed)
    full = schedule_node(nc, hw, n_cores, topology=topology,
                         partition=partition)
    wall_full = time.perf_counter() - t0

    t0 = time.perf_counter()
    sam = sampled_schedule_node(prog, hw, n_cores, topology, partition,
                                config, compute_dtype, costed)
    wall_sampled = time.perf_counter() - t0

    err = (sam.t_est - full.t_est) / max(full.t_est, 1e-30)
    return {
        "n_ops": len(prog.ops),
        "n_instances": sam.plan.n_instances,
        "n_intervals": sam.plan.n_intervals,
        "k": sam.plan.k,
        "frac_ops_scheduled": sam.plan.frac_ops_scheduled,
        "t_full_us": full.t_est * 1e6,
        "t_sampled_us": sam.t_est * 1e6,
        "reconstruction_error_pct": 100.0 * err,
        "bound_by_full": full.schedule.bound_by,
        "bound_by_sampled": sam.bound_by,
        "wall_full_s": wall_full,
        "wall_sampled_s": wall_sampled,
        "speedup": wall_full / max(wall_sampled, 1e-30),
    }
