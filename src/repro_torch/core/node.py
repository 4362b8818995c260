"""Multi-core node engine — contention-aware scheduling across CMG cores.

A copy of ``repro.core.node``, held bit for bit against it.  The
reference's jitted ``lax.scan`` pass (``_node_pass_batch_jax``,
``backend="jax"``) becomes ``backend="torch"``: each pass of the batched
fixpoint runs through ``kernels.sched_scan.node_scan``, the hand-written
scan on a card (its plain PyTorch version for CPU tensors), bit-identical
to the NumPy pass; the fixpoint's duration math stays NumPy on the host.

The paper's stated target is the execution time of *one node* application;
PRs 1-3 built a per-kernel cost model (one core, or one core drawing a
hardcoded share of the CMG's bandwidth).  This module is the node layer
on top of the compiled SoA core (DESIGN.md §14):

* a per-core ``HardwareSpec`` plus a :class:`~.hwspec.NodeTopology`
  describe the node: per-core paths are single-core draw limits,
  ``MemLevel.shared_by`` marks CMG-shared levels, the topology carries
  each sharing domain's aggregate bandwidth and the inter-CMG ring;
* a costed :class:`~.hlo.Program` is partitioned across cores —
  op-level round-robin, a def-use-aware greedy graph partition, or
  OpenMP-style data-parallel sharding (every core runs the whole program
  at ``1/n_cores`` of the work, the kernel-suite mode);
* one in-order stream per core runs through the existing compiled
  machinery (per-``(core, port)`` pipes, per-core ROB windows and
  reservation queues — the same float ops as ``schedule_arrays``, which
  is why ``n_cores=1`` under a degenerate topology is bit-identical to
  the single-core fast path), with readiness propagated globally across
  cores and cross-CMG def-use edges charged the ring latency;
* a bandwidth-contention fixpoint divides each shared level's aggregate
  among the cores actively streaming through it: the concurrently-active
  estimate ``n_active = clamp(sum_c busy_c / t_node, 1, cores)`` feeds
  back into per-op memory times (reusing ``route_program``'s per-level
  residency split) until it stabilizes.

``schedule_node`` returns a :class:`NodeResult`: per-core timelines, a
node-level :class:`~.schedule.ScheduleResult`, per-CMG contention/
occupancy, and the zero-contention bound (the fixpoint's first
iteration), so every estimate ships with its own sandwich
``t_zero_contention <= t_est <= t_single_core`` (asserted by the node
test harness).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .compiled import (PORTS, CompiledProgram, O3Knobs, check_backend,
                       compile_program)
from .cost import BatchCosted, OpTime, cost_program, cost_program_batch
from .hlo import Program
from .hwspec import HardwareSpec, NodeTopology, SpecGrid
from .schedule import ScheduleResult

_NODE_CACHE_SIZE = 8


def effective_bandwidth(core_bw, shared_bw, n_active):
    """Per-core effective bandwidth at a shared level: the single-core
    draw limit, capped by an equal share of the domain aggregate among
    the ``n_active`` cores concurrently streaming through it.  Monotone
    non-increasing in ``n_active`` (property-tested).  Scalar or
    elementwise over arrays — ``_eff_inv`` calls this, so the property
    test binds the engine's actual contention math."""
    if shared_bw is None:
        return core_bw
    return np.minimum(core_bw, shared_bw / np.maximum(n_active, 1.0))


# ------------------------------------------------------------ compiled form
@dataclass
class NodeCompiled:
    """Per-(program, spec, dtype) node form: the single-core compiled
    program plus the per-op/per-level cost decomposition the contention
    fixpoint rescales (``t_mem = rd @ inv_read + wr @ inv_write + lat``).
    """
    cp: CompiledProgram
    n: int
    t_comp: np.ndarray           # [n] per-instance compute time
    t_ici: np.ndarray            # [n]
    lat: np.ndarray              # [n] hierarchy access latency (uncontended)
    count: np.ndarray            # [n]
    rd: np.ndarray               # [n, L] routed read bytes per level
    wr: np.ndarray               # [n, L] routed write bytes per level
    level_names: Tuple[str, ...]
    core_read_bw: np.ndarray     # [L] per-core paths
    core_write_bw: np.ndarray
    shared_by: np.ndarray        # [L] sharing-domain size per level
    startup: float
    costed_mask: np.ndarray = None   # [n] bool: port_id >= 0


def compile_node(prog: Program, hw: HardwareSpec,
                 links_per_collective: int = 2,
                 compute_dtype: Optional[str] = None,
                 costed: Optional[List[Optional[OpTime]]] = None
                 ) -> NodeCompiled:
    """Compile (and memoize on the Program) the node form.  The cache is
    keyed by the frozen spec's VALUE (like ``compile_program``'s), so a
    value-equal spec rebuilt via ``dataclasses.replace``/``with_`` hits
    it.  A caller-supplied ``costed`` list bypasses the cache, mirroring
    ``compile_program``."""
    if costed is None:
        cache = prog.__dict__.setdefault("_node_cache", [])
        for chw, cdt, clk, cnc in cache:
            if cdt == compute_dtype and clk == links_per_collective \
                    and chw == hw:
                return cnc
        costed = cost_program(prog, hw, links_per_collective, compute_dtype)
    else:
        cache = None
    cp = compile_program(prog, hw, links_per_collective, compute_dtype,
                         costed=costed)
    levels = hw.memory_hierarchy()
    L = len(levels)
    n = len(prog.ops)
    lidx = {lv.name: i for i, lv in enumerate(levels)}
    t_comp = np.zeros(n)
    t_ici = np.zeros(n)
    lat = np.zeros(n)
    count = np.ones(n)
    rd = np.zeros((n, L))
    wr = np.zeros((n, L))
    for i, ot in enumerate(costed):
        if ot is None:
            continue
        t_comp[i] = ot.t_compute
        t_ici[i] = ot.t_ici
        count[i] = ot.op.count
        tr = ot.traffic
        if tr is not None:
            lat[i] = tr.latency_s
            for nm, b in tr.read_by_level.items():
                rd[i, lidx[nm]] = b
            for nm, b in tr.write_by_level.items():
                wr[i, lidx[nm]] = b
    nc = NodeCompiled(
        cp=cp, n=n, t_comp=t_comp, t_ici=t_ici, lat=lat, count=count,
        rd=rd, wr=wr, level_names=tuple(lv.name for lv in levels),
        core_read_bw=np.array([lv.read_bw for lv in levels]),
        core_write_bw=np.array([lv.write_bw for lv in levels]),
        shared_by=np.array([max(1, lv.shared_by) for lv in levels],
                           dtype=np.int64),
        startup=hw.op_startup_ns * 1e-9,
        costed_mask=cp.port_id >= 0,
    )
    if cache is not None:
        cache.append((hw, compute_dtype, links_per_collective, nc))
        if len(cache) > _NODE_CACHE_SIZE:
            cache.pop(0)
    return nc


# ------------------------------------------------------------- partitioning
def partition_round_robin(n: int, n_cores: int) -> np.ndarray:
    """Op-level round-robin over program order (free ops included: they
    occupy their core's ROB slots exactly like the single-core kernels)."""
    return np.arange(n, dtype=np.int64) % max(1, n_cores)


def partition_graph(nc: NodeCompiled, n_cores: int,
                    balance: float = 1.25) -> np.ndarray:
    """Def-use-aware greedy partition: follow each op's heaviest producer
    onto its core while that core's load stays under ``balance`` x the
    even share, else fall to the least-loaded core.  Keeps dependence
    chains co-located (fewer cross-core readiness waits and ring hops)
    while bounding imbalance.  Deterministic."""
    n_cores = max(1, n_cores)
    durs = nc.cp._dur_l
    indptr = nc.cp._indptr_l
    indices = nc.cp._indices_l
    core_of = np.zeros(nc.n, dtype=np.int64)
    load = [0.0] * n_cores
    cap = balance * (sum(durs) / n_cores) + 1e-30
    for i in range(nc.n):
        pref = -1
        best = -1.0
        for k in range(indptr[i], indptr[i + 1]):
            j = indices[k]
            if durs[j] > best:
                best, pref = durs[j], int(core_of[j])
        if pref < 0 or load[pref] + durs[i] > cap:
            pref = min(range(n_cores), key=load.__getitem__)
        core_of[i] = pref
        load[pref] += durs[i]
    return core_of


# ------------------------------------------------------- the node scheduler
def _node_pass(durs, ports, indptr, indices, core_of, cmg_of_core,
               widths, depths, window, ring_lat):
    """One global in-order pass over the ops with per-(core, port) pipes,
    per-core ROB windows and reservation queues, and globally-propagated
    readiness (+ ring latency on cross-CMG def-use edges).  With one core
    this replays ``schedule_arrays``'s float operations in the same
    order, hence bit-identical results (the differential tests pin it).
    """
    n = len(durs)
    P = len(PORTS)
    n_cores = len(cmg_of_core)
    finishes = [0.0] * n
    starts = [0.0] * n
    rt_tail = [0.0] * n_cores                 # per-core worst retire seen
    # Bounded ring buffers (they were O(n)-growing lists): the ROB check
    # only ever reads the retire entry `window` positions back on the
    # op's core, and the queue check the issue start `depth` back on the
    # op's (core, port) — slot (pos - window) % window == pos % window,
    # so one window-sized ring per core (and one depth-sized ring per
    # pipe) replays the exact same reads.  A ring never needs more slots
    # than the stream has ops: when window > n the read is unreachable.
    rt_size = max(1, min(window, n))
    rt_ring: List[Optional[List[float]]] = [None] * n_cores
    rt_pos = [0] * n_cores                    # per-core ops seen (= old len)
    pipes: List[List[Optional[List[float]]]] = \
        [[None] * P for _ in range(n_cores)]
    hist: List[List[Optional[List[float]]]] = \
        [[None] * P for _ in range(n_cores)]
    hist_pos = [[0] * P for _ in range(n_cores)]
    core_busy = [[0.0] * P for _ in range(n_cores)]
    core_finish = [0.0] * n_cores
    core_nops = [0] * n_cores
    s_port = s_window = s_queue = 0.0
    t_est = 0.0
    use_ring = ring_lat > 0.0 and n_cores > 1
    # a value's home CMG: where it was produced.  Free ops (gte/bitcast/
    # tuple) are pass-throughs — they inherit their binding producer's
    # home and charge no hop themselves, so data consumed on its own CMG
    # through a scattered free op pays no phantom ring latency
    home = [0] * n if use_ring else None

    for i in range(n):
        c = core_of[i]
        p = ports[i]
        ready = 0.0
        if use_ring:
            mycmg = cmg_of_core[c]
            if p < 0:
                for k in range(indptr[i], indptr[i + 1]):
                    f = finishes[indices[k]]
                    if f > ready:
                        ready = f
                # home = first producer's (static, so the scheduler and
                # _dataflow always agree; gte/bitcast have exactly one)
                home[i] = (home[indices[indptr[i]]]
                           if indptr[i + 1] > indptr[i] else mycmg)
            else:
                for k in range(indptr[i], indptr[i + 1]):
                    j = indices[k]
                    f = finishes[j]
                    if home[j] != mycmg:
                        f += ring_lat
                    if f > ready:
                        ready = f
                home[i] = mycmg
        else:
            for k in range(indptr[i], indptr[i + 1]):
                f = finishes[indices[k]]
                if f > ready:
                    ready = f
        crt = rt_ring[c]
        if crt is None:
            crt = rt_ring[c] = [0.0] * rt_size
        pos = rt_pos[c]
        rt_pos[c] = pos + 1
        if p < 0:
            # free op: propagate readiness at zero cost; occupies a ROB slot
            finishes[i] = ready
            starts[i] = ready
            rp = rt_tail[c]
            if ready > rp:
                rp = ready
                rt_tail[c] = rp
            crt[pos % rt_size] = rp
            continue
        pl = pipes[c][p]
        d = depths[p]
        if pl is None:
            pl = pipes[c][p] = [0.0] * widths[p]
            hist[c][p] = [0.0] * d
        start = ready
        why = 0
        pf = min(pl)
        if pf > start:
            start, why = pf, 1
        if pos >= window:
            wt = crt[pos % rt_size]      # == (pos - window) % window
            if wt > start:
                start, why = wt, 2
        h = hist[c][p]
        hp = hist_pos[c][p]
        if hp >= d:
            qt = h[hp % d]               # == (hp - d) % d
            if qt > start:
                start, why = qt, 3
        finish = start + durs[i]
        pl[pl.index(pf)] = finish
        h[hp % d] = start
        hist_pos[c][p] = hp + 1
        finishes[i] = finish
        starts[i] = start
        rp = rt_tail[c]
        if finish > rp:
            rp = finish
            rt_tail[c] = rp
        crt[pos % rt_size] = rp
        if finish > t_est:
            t_est = finish
        if finish > core_finish[c]:
            core_finish[c] = finish
        core_busy[c][p] += durs[i]
        core_nops[c] += 1
        if start > ready:
            dt = start - ready
            if why == 1:
                s_port += dt
            elif why == 2:
                s_window += dt
            else:
                s_queue += dt

    stall: Dict[str, float] = {}
    if s_port > 0:
        stall["port"] = s_port
    if s_window > 0:
        stall["window"] = s_window
    if s_queue > 0:
        stall["queue"] = s_queue
    return (t_est, stall, starts, finishes, core_busy, core_finish,
            core_nops)


def _dataflow(durs, ports, indptr, indices, core_of, cmg_of_core, ring_lat):
    """Infinite-resource critical path of the partitioned program,
    ring-latency edges included — the node schedule can never beat it.
    Mirrors the scheduler's ring rules: hops are charged against a
    value's HOME CMG (free pass-through ops inherit, not relay), and the
    makespan is the max over *costed* ops (free ops take no time, so a
    hop into a terminal free op is phantom, exactly as in t_est)."""
    n = len(durs)
    length = [0.0] * n
    t_df = 0.0
    use_ring = ring_lat > 0.0 and len(cmg_of_core) > 1
    home = [0] * n if use_ring else None
    for i in range(n):
        best = 0.0
        if use_ring:
            mycmg = cmg_of_core[core_of[i]]
            if ports[i] < 0:
                for k in range(indptr[i], indptr[i + 1]):
                    v = length[indices[k]]
                    if v > best:
                        best = v
                home[i] = (home[indices[indptr[i]]]
                           if indptr[i + 1] > indptr[i] else mycmg)
            else:
                for k in range(indptr[i], indptr[i + 1]):
                    j = indices[k]
                    v = length[j]
                    if home[j] != mycmg:
                        v += ring_lat
                    if v > best:
                        best = v
                home[i] = mycmg
        else:
            for k in range(indptr[i], indptr[i + 1]):
                v = length[indices[k]]
                if v > best:
                    best = v
        length[i] = durs[i] + best
        if ports[i] >= 0 and length[i] > t_df:
            t_df = length[i]
    return t_df


# ------------------------------------------------------------------ results
@dataclass
class CoreStat:
    """Per-core schedule stats of one node run."""
    core: int
    cmg: int
    t_finish: float              # last finish on this core
    port_busy: Dict[str, float]
    n_ops: int


@dataclass
class CmgStat:
    """Per-CMG contention report: active-core estimates + effective
    bandwidths at each shared level (DESIGN.md §14).
    """
    cmg: int
    n_cores: int                 # cores of this CMG used by the run
    n_active: Dict[str, float]   # level -> concurrently-active estimate
    eff_read_bw: Dict[str, float]    # per-core effective bytes/s
    eff_write_bw: Dict[str, float]
    occupancy: float             # max core-busy fraction of node makespan


@dataclass
class NodeResult:
    """Per-core timelines + node-level schedule + contention report
    (the multi-core node engine's output, DESIGN.md §14).

    ``t_est`` is the contention-aware node makespan;
    ``t_zero_contention`` the fixpoint's uncontended first pass, so every
    estimate ships inside the sandwich ``t_zero_contention <= t_est <=
    t_single_core`` (pinned by ``tests/test_node_engine.py``).
    ``schedule`` aggregates the per-core streams into a
    :class:`~.schedule.ScheduleResult`; ``per_cmg`` carries each CMG's
    concurrently-active estimates and effective shared-level bandwidths.
    Produced by ``schedule_node``/``simulate_node`` and surfaced as
    ``SimReport.node`` under ``simulate(engine="node")``; the model-zoo
    pipeline (DESIGN.md §15) sweeps it across a core-count axis.
    """
    t_est: float
    n_cores: int
    partition: str
    topology: NodeTopology
    schedule: ScheduleResult     # node-level aggregate
    per_core: List[CoreStat]
    per_cmg: List[CmgStat]
    t_zero_contention: float     # fixpoint iteration 0 (all levels at the
                                 # per-core draw limit): the lower bound
    iterations: int
    core_of: np.ndarray = field(repr=False, default=None)
    starts: np.ndarray = field(repr=False, default=None)
    finishes: np.ndarray = field(repr=False, default=None)

    @property
    def parallel_efficiency(self) -> float:
        """Busy time across cores / (n_cores x makespan)."""
        if self.t_est <= 0 or not self.per_core:
            return 1.0
        busy = sum(sum(c.port_busy.values()) for c in self.per_core)
        return busy / (len(self.per_core) * self.t_est)


# --------------------------------------------------------------- the engine
def _eff_inv(nc: NodeCompiled, topo: NodeTopology, cores: np.ndarray,
             n_active: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """[k, L] inverse effective read/write bandwidth per used core."""
    k = len(cores)
    L = len(nc.level_names)
    inv_r = np.empty((k, L))
    inv_w = np.empty((k, L))
    for li, name in enumerate(nc.level_names):
        dom = cores // nc.shared_by[li]
        na = n_active[li][dom]
        inv_r[:, li] = 1.0 / effective_bandwidth(
            nc.core_read_bw[li], topo.shared_read_bw.get(name), na)
        inv_w[:, li] = 1.0 / effective_bandwidth(
            nc.core_write_bw[li], topo.shared_write_bw.get(name), na)
    return inv_r, inv_w


def _contended_durs_arr(nc: NodeCompiled, inv_r_op: np.ndarray,
                        inv_w_op: np.ndarray, scale: float) -> np.ndarray:
    """Per-op durations under the given per-op inverse bandwidths; work
    (flops/bytes) scaled by ``scale`` (sharding), latency and startup
    unscaled (every core still issues its slice of each op).  Collective
    time is NOT scaled: the payload rides the node-level interconnect,
    which every core's slice serializes on — sharding an op across more
    cores does not add inter-node links (the cluster engine's degenerate
    case pins this)."""
    t_mem = ((nc.rd * inv_r_op).sum(axis=1)
             + (nc.wr * inv_w_op).sum(axis=1)) * scale + nc.lat
    per = np.maximum(np.maximum(nc.t_comp * scale, t_mem), nc.t_ici)
    durs = (per + nc.startup) * nc.count
    # uncosted ops must stay zero-duration free ops
    durs[~nc.costed_mask] = 0.0
    return durs


def _contended_durs(nc: NodeCompiled, inv_r_op: np.ndarray,
                    inv_w_op: np.ndarray, scale: float) -> List[float]:
    """List form of :func:`_contended_durs_arr` for the scalar pass."""
    return _contended_durs_arr(nc, inv_r_op, inv_w_op, scale).tolist()


def _resolve_partition(nc: NodeCompiled, topo: NodeTopology, n_cores: int,
                       partition: str, core_of: Optional[np.ndarray]):
    """Partition plumbing shared by the scalar and batched engines:
    ``(sched_core_of, sched_cmgs, shard, scale, ring_lat, cores)``."""
    shard = partition == "shard"
    # cores used by this run (compact pinning: CMG c//cores_per_cmg)
    cores = np.arange(n_cores, dtype=np.int64)
    cmg_of_used = (cores // max(1, topo.cores_per_cmg)).tolist()
    if shard:
        sched_core_of = np.zeros(nc.n, dtype=np.int64)
        sched_cmgs = [0]
    elif core_of is not None:
        sched_core_of = np.asarray(core_of, dtype=np.int64)
        sched_cmgs = cmg_of_used
    elif partition == "graph":
        sched_core_of = partition_graph(nc, n_cores)
        sched_cmgs = cmg_of_used
    elif partition == "round-robin":
        sched_core_of = partition_round_robin(nc.n, n_cores)
        sched_cmgs = cmg_of_used
    else:
        raise ValueError(f"unknown partition {partition!r}")
    ring_lat = topo.ring_latency_s if not shard else 0.0
    scale = (1.0 / n_cores) if shard else 1.0
    return sched_core_of, sched_cmgs, shard, scale, ring_lat, cores


def _work_domains(nc: NodeCompiled, n_cores: int, shard: bool,
                  sched_core_of: np.ndarray, cores: np.ndarray):
    """Initial ``n_active`` (all ones) and per-domain active-core caps
    (cores of each sharing domain that actually have costed work)."""
    L = len(nc.level_names)
    n_active = [np.ones(int(np.ceil(n_cores / nc.shared_by[li])))
                for li in range(L)]
    port_arr = np.asarray(nc.cp._port_l)
    if shard:
        work_cores = cores          # every virtual core runs the stream
    else:
        has_work = np.zeros(n_cores, dtype=bool)
        has_work[sched_core_of[port_arr >= 0]] = True
        work_cores = cores[has_work[cores]]
    active_per_dom = [np.maximum(np.bincount(
        work_cores // nc.shared_by[li],
        minlength=len(n_active[li])).astype(float), 1.0)
        for li in range(L)]
    return n_active, active_per_dom


def _update_active(nc: NodeCompiled, topo: NodeTopology, cores: np.ndarray,
                   n_active: List[np.ndarray], sched_core_of: np.ndarray,
                   shard: bool, scale: float, n_cores: int, t_node: float,
                   active_per_dom: List[np.ndarray], damp: float):
    """One fixpoint update of the concurrently-active estimates:
    analytic per-core level-busy under the current bandwidths, then
    ``n_active = damp * clamp(dom_busy / t_node, 1, active) + (1-damp) *
    prev``.  Returns ``(new_active, delta)``.  Pure function of its
    inputs — the batched driver replays the scalar trajectory with it."""
    L = len(nc.level_names)
    inv_r, inv_w = _eff_inv(nc, topo, cores, n_active)
    stream_inv_r = inv_r[0] if shard else inv_r[sched_core_of]
    stream_inv_w = inv_w[0] if shard else inv_w[sched_core_of]
    contrib = (nc.rd * stream_inv_r + nc.wr * stream_inv_w) \
        * (scale * nc.count)[:, None]
    if shard:
        core_level_busy = np.broadcast_to(contrib.sum(axis=0),
                                          (n_cores, L))
    delta = 0.0
    new_active = []
    for li in range(L):
        if shard:
            dom_busy = np.bincount(cores // nc.shared_by[li],
                                   weights=core_level_busy[:, li],
                                   minlength=len(n_active[li]))
        else:
            # domain-sum the per-op contributions directly (one weighted
            # bincount; np.add.at into per-core rows was the hot spot)
            dom_busy = np.bincount(sched_core_of // nc.shared_by[li],
                                   weights=contrib[:, li],
                                   minlength=len(n_active[li]))
        target = np.clip(dom_busy / max(t_node, 1e-30), 1.0,
                         active_per_dom[li])
        nxt = damp * target + (1.0 - damp) * n_active[li]
        delta = max(delta, float(np.abs(nxt - n_active[li]).max(
            initial=0.0)))
        new_active.append(nxt)
    return new_active, delta


def schedule_node(nc: NodeCompiled, hw: HardwareSpec, n_cores: int,
                  topology: Optional[NodeTopology] = None,
                  partition: str = "round-robin",
                  core_of: Optional[np.ndarray] = None,
                  max_iters: int = 8, tol: float = 1e-2) -> NodeResult:
    """Schedule the compiled node form on ``n_cores`` cores.

    ``partition``: ``"round-robin"`` | ``"graph"`` | ``"shard"`` (every
    core runs the whole program at 1/n_cores of the work — the OpenMP
    thread-scaling mode the kernel suite reports), or pass an explicit
    ``core_of`` array.  The contention fixpoint starts uncontended (its
    first pass IS the zero-contention bound); the first update jumps
    straight to the measured concurrently-active estimate (fully
    mem-bound programs converge in one step because busy and makespan
    rescale together), later updates are 0.5-damped against oscillation,
    and the loop stops when the estimate moves less than ``tol`` cores.
    """
    topo = topology or hw.topology or NodeTopology.degenerate(n_cores)
    if n_cores < 1 or n_cores > max(topo.n_cores, 1):
        raise ValueError(f"n_cores={n_cores} outside topology "
                         f"{topo.name} (max {topo.n_cores})")
    cp = nc.cp
    widths = [max(1, hw.issue_width.get(p, 1)) for p in PORTS]
    depths = [max(1, hw.queue_depth.get(p, 1)) for p in PORTS]
    window = max(1, hw.inflight_window)
    sched_core_of, sched_cmgs, shard, scale, ring_lat, cores = \
        _resolve_partition(nc, topo, n_cores, partition, core_of)
    cmg_of_used = (cores // max(1, topo.cores_per_cmg)).tolist()
    core_of_l = sched_core_of.tolist()

    # a level is contended only when the topology caps it AND >1 core
    # shares the domain; otherwise the fixpoint is a single exact pass
    has_caps = any(nm in topo.shared_read_bw or nm in topo.shared_write_bw
                   for nm in nc.level_names)
    contended = has_caps and n_cores > 1

    # concurrently-active estimate per (level, sharing domain) + the
    # cores of each domain that actually have costed work
    n_active, active_per_dom = _work_domains(nc, n_cores, shard,
                                             sched_core_of, cores)

    ports_l = cp._port_l
    indptr_l = cp._indptr_l
    indices_l = cp._indices_l

    t_zero = None
    iterations = 0
    final = not contended
    while True:
        iterations += 1
        uncontended = all(float(a.max(initial=1.0)) <= 1.0
                          for a in n_active)
        if uncontended and scale == 1.0:
            # exact path: reuse the single-core compiled durations
            # bit-for-bit (recomposing t_mem from the per-level split
            # reassociates float adds)
            durs = cp._dur_l
        else:
            inv_r, inv_w = _eff_inv(nc, topo, cores, n_active)
            if shard:
                # every virtual core runs the stream; core 0 sits in the
                # fullest sharing domain (compact pinning), so its
                # bandwidths govern the makespan
                row, row_w = inv_r[0], inv_w[0]
            else:
                row, row_w = inv_r[sched_core_of], inv_w[sched_core_of]
            durs = _contended_durs(nc, row, row_w, scale)
        res = _node_pass(durs, ports_l, indptr_l, indices_l, core_of_l,
                         sched_cmgs, widths, depths, window, ring_lat)
        t_node = res[0]
        if t_zero is None:
            t_zero = t_node
        if final:
            break
        damp = 0.5 if iterations > 1 else 1.0
        n_active, delta = _update_active(
            nc, topo, cores, n_active, sched_core_of, shard, scale,
            n_cores, t_node, active_per_dom, damp)
        if delta == 0.0:
            # n_active (hence durations) unchanged: the pass just taken
            # IS the converged schedule — no re-run needed (the common
            # compute-bound case, where every target clamps to 1)
            break
        # once the estimate stops moving (or the budget runs out), one
        # last pass of the same block above runs under the converged
        # n_active and breaks
        final = delta < tol or iterations >= max_iters

    t_est, stall, starts, finishes, core_busy, core_finish, core_nops = res

    # --- node-level ScheduleResult.  In shard mode the pass scheduled ONE
    # representative stream; every core runs it, so node aggregates
    # (port_busy / t_serial / n_ops) scale by n_cores — keeping their
    # semantics identical to the op-partition modes, where the pass
    # already covers all cores.
    agg = float(n_cores) if shard else 1.0
    port_busy: Dict[str, float] = {}
    for cb in core_busy:
        for pid, b in enumerate(cb):
            if b > 0:
                port_busy[PORTS[pid]] = port_busy.get(PORTS[pid], 0.0) \
                    + b * agg
    # schedule-consistent lower bound: busiest (core, port) pipe
    per_core_roof = max((b / widths[pid]
                         for cb in core_busy for pid, b in enumerate(cb)
                         if b > 0), default=0.0)
    t_serial = float(sum(durs)) * agg
    t_dataflow = _dataflow(durs, ports_l, indptr_l, indices_l, core_of_l,
                           sched_cmgs, ring_lat)
    sched = ScheduleResult(
        t_est=t_est, t_roofline=per_core_roof, t_serial=t_serial,
        t_dataflow=t_dataflow, port_busy=port_busy,
        n_ops=cp.n_ops * agg, n_edges=cp.n_edges, stall_by_reason=stall,
        issue_width=dict(hw.issue_width))

    # --- per-core stats (shard: every core runs the representative stream)
    per_core: List[CoreStat] = []
    for c in range(n_cores):
        src = 0 if shard else c
        per_core.append(CoreStat(
            core=c, cmg=int(cmg_of_used[c]),
            t_finish=core_finish[src],
            port_busy={PORTS[pid]: b for pid, b in
                       enumerate(core_busy[src]) if b > 0},
            n_ops=core_nops[src]))

    # --- per-CMG contention report
    per_cmg: List[CmgStat] = []
    inv_final = _eff_inv(nc, topo, cores, n_active)
    mk = max(t_est, 1e-30)
    for g in range(int(max(cmg_of_used)) + 1):
        gcores = [c for c in range(n_cores) if cmg_of_used[c] == g]
        na: Dict[str, float] = {}
        er: Dict[str, float] = {}
        ew: Dict[str, float] = {}
        for li, nm in enumerate(nc.level_names):
            if nm not in topo.shared_read_bw and \
                    nm not in topo.shared_write_bw:
                continue
            dom = gcores[0] // int(nc.shared_by[li])
            na[nm] = float(n_active[li][dom])
            er[nm] = 1.0 / float(inv_final[0][gcores[0], li])
            ew[nm] = 1.0 / float(inv_final[1][gcores[0], li])
        occ = max((sum(core_busy[0 if shard else c]) / mk
                   for c in gcores), default=0.0)
        per_cmg.append(CmgStat(cmg=g, n_cores=len(gcores), n_active=na,
                               eff_read_bw=er, eff_write_bw=ew,
                               occupancy=occ))

    return NodeResult(
        t_est=t_est, n_cores=n_cores, partition=partition, topology=topo,
        schedule=sched, per_core=per_core, per_cmg=per_cmg,
        t_zero_contention=t_zero, iterations=iterations,
        core_of=sched_core_of, starts=np.asarray(starts),
        finishes=np.asarray(finishes))


# ------------------------------------------------------- batched engine
@dataclass
class NodeCompiledBatch:
    """Partition-resolved node form for the batched engine (DESIGN.md
    §17): everything about the pass that does NOT depend on the knob
    combo or the duration row — stream assignment, per-stream op
    positions, per-(stream, port) costed-op positions, and the
    precomputed ring-latency addend per def-use edge (the cross-CMG edge
    mask, folded with the free-op home inheritance once at compile
    time).  ``_node_pass_batch`` runs any number of (knobs x durations)
    batch elements over one of these in lockstep."""
    nc: NodeCompiled
    topo: NodeTopology
    partition: str
    shard: bool
    ring_lat: float
    sched_core_of: np.ndarray        # [n] scheduling stream per op
    core_of_l: List[int]             # python mirror of sched_core_of
    cmg_of_stream: List[int]         # per scheduled stream
    n_streams: int
    pos_in_core: np.ndarray          # [n] running op index on its stream
    pos_in_cp: np.ndarray            # [n] costed-op index on its pipe
    cpid: np.ndarray                 # [n] stream * P + port (0 for free)
    core_ops: np.ndarray             # [S] ops per stream (free included)
    cp_counts: np.ndarray            # [S * P] costed ops per pipe
    edge_extra: Optional[np.ndarray]  # [E] ring addend per CSR edge


def compile_node_batch(nc: NodeCompiled, hw: HardwareSpec, n_cores: int,
                       topology: Optional[NodeTopology] = None,
                       partition: str = "shard",
                       core_of: Optional[np.ndarray] = None
                       ) -> NodeCompiledBatch:
    """Resolve a partition of ``nc`` into the batched pass form.  In
    shard mode the structure is core-count independent (one stream, no
    ring), so one form serves a whole core-count sweep.

    Memoized on the ``NodeCompiled`` keyed by ``(topo, partition,
    n_cores)`` — with the core count dropped for shard forms, whose
    structure does not depend on it.  The key sees the resolved
    topology VALUE, so two sweeps over equal topologies share one form
    while a spec-grid sweep with per-spec topologies can never alias
    another grid's entry.  An explicit ``core_of`` bypasses the cache
    (the key cannot see the array)."""
    topo = topology or hw.topology or NodeTopology.degenerate(n_cores)
    if n_cores < 1 or n_cores > max(topo.n_cores, 1):
        raise ValueError(f"n_cores={n_cores} outside topology "
                         f"{topo.name} (max {topo.n_cores})")
    cache = None
    if core_of is None:
        key = (topo, partition,
               None if partition == "shard" else n_cores)
        cache = nc.__dict__.setdefault("_batch_cache", [])
        for ck, cnb in cache:
            if ck == key:
                return cnb
    sched_core_of, sched_cmgs, shard, _scale, ring_lat, _cores = \
        _resolve_partition(nc, topo, n_cores, partition, core_of)
    n = nc.n
    P = len(PORTS)
    ports = nc.cp._port_l
    indptr = nc.cp._indptr_l
    indices = nc.cp._indices_l
    core_l = sched_core_of.tolist()
    S = len(sched_cmgs)
    pos_in_core = np.zeros(n, dtype=np.int64)
    pos_in_cp = np.zeros(n, dtype=np.int64)
    cpid = np.zeros(n, dtype=np.int64)
    core_ops = [0] * S
    cp_counts = [0] * (S * P)
    for i in range(n):
        c = core_l[i]
        pos_in_core[i] = core_ops[c]
        core_ops[c] += 1
        p = ports[i]
        if p >= 0:
            pid = c * P + p
            cpid[i] = pid
            pos_in_cp[i] = cp_counts[pid]
            cp_counts[pid] += 1
    edge_extra = None
    if ring_lat > 0.0 and S > 1:
        # fold the scalar pass's home-CMG walk into a per-edge addend:
        # free ops inherit their binding producer's home, costed ops
        # charge ring_lat on every edge from a foreign-home producer
        edge_extra = np.zeros(len(indices))
        home = [0] * n
        for i in range(n):
            mycmg = sched_cmgs[core_l[i]]
            if ports[i] < 0:
                home[i] = (home[indices[indptr[i]]]
                           if indptr[i + 1] > indptr[i] else mycmg)
            else:
                for k in range(indptr[i], indptr[i + 1]):
                    if home[indices[k]] != mycmg:
                        edge_extra[k] = ring_lat
                home[i] = mycmg
        if not edge_extra.any():
            edge_extra = None
    nb = NodeCompiledBatch(
        nc=nc, topo=topo, partition=partition, shard=shard,
        ring_lat=ring_lat, sched_core_of=sched_core_of, core_of_l=core_l,
        cmg_of_stream=list(sched_cmgs), n_streams=S,
        pos_in_core=pos_in_core, pos_in_cp=pos_in_cp, cpid=cpid,
        core_ops=np.asarray(core_ops, dtype=np.int64),
        cp_counts=np.asarray(cp_counts, dtype=np.int64),
        edge_extra=edge_extra)
    if cache is not None:
        cache.append((key, nb))
        if len(cache) > _NODE_CACHE_SIZE:
            cache.pop(0)
    return nb


def _node_pass_batch(nb: NodeCompiledBatch, durs_cols: np.ndarray,
                     window: np.ndarray, width: np.ndarray,
                     depth: np.ndarray) -> np.ndarray:
    """One vectorized in-order pass: M batch elements (knob combo x
    duration row) advance op-by-op in lockstep, each replaying the
    scalar ``_node_pass``'s float operations in the same order — every
    element's result is bit-identical to the reference kernel's (the
    node differential suite pins it).  ``durs_cols`` is ``[n, M]``
    (element durations as columns); ``window [M]``, ``width/depth
    [M, P]``.  Returns ``t_est [M]``."""
    nc = nb.nc
    n = nc.n
    M = len(window)
    if n == 0 or M == 0:
        return np.zeros(M)
    P = len(PORTS)
    indptr = nc.cp.dep_indptr
    indices = nc.cp.dep_indices
    ports = nc.cp._port_l
    extra = nb.edge_extra
    core_l = nb.core_of_l
    pos_core = nb.pos_in_core.tolist()
    pos_cp = nb.pos_in_cp.tolist()
    cpid_l = nb.cpid.tolist()
    S = nb.n_streams
    arange_m = np.arange(M)
    zeros_m = np.zeros(M)                          # read-only
    finishes = np.empty((n, M))
    # Rings sized EXACTLY max(window) / max(depth[:, p]) need no
    # validity masking: a read at slot (pos - window_m) % wmax either
    # hits the live entry `window_m` back (age <= wmax, never yet
    # overwritten) or — when pos < window_m — an unwritten slot still
    # holding 0.0, which is a no-op under max against a non-negative
    # start.  Read slots are precomputed per (position, element) so the
    # hot loop is pure gathers.
    wmax = int(window.max())
    rt_rings: List[Optional[np.ndarray]] = [None] * S
    rt_tail = np.zeros((S, M))
    max_pos = int(max(nb.core_ops.max(), 1))
    rob_slot = (np.arange(max_pos)[:, None] - window[None, :]) % wmax
    dmax = [max(1, int(d)) for d in depth.max(axis=0)]      # per port
    q_slot: List[Optional[np.ndarray]] = [None] * P
    for p in range(P):
        mq = int(nb.cp_counts[np.arange(S) * P + p].max(initial=0))
        if mq > 0:
            q_slot[p] = (np.arange(mq)[:, None] - depth[None, :, p]) \
                % dmax[p]
    pipes: List[Optional[np.ndarray]] = [None] * (S * P)
    hists: List[Optional[np.ndarray]] = [None] * (S * P)
    lane_arange = np.arange(max(1, int(width.max())))
    maximum = np.maximum

    for i in range(n):
        lo = indptr[i]
        hi = indptr[i + 1]
        nd = hi - lo
        if nd == 1:
            j = indices[lo]
            if extra is None or extra[lo] == 0.0:
                ready = finishes[j]        # view; never written through
            else:
                ready = finishes[j] + extra[lo]
        elif nd == 0:
            ready = zeros_m
        else:
            dep_f = finishes[indices[lo:hi]]
            if extra is not None:
                ex = extra[lo:hi]
                if ex.any():
                    dep_f = dep_f + ex[:, None]
            ready = dep_f.max(axis=0)
        c = core_l[i]
        rr = rt_rings[c]
        if rr is None:
            rr = rt_rings[c] = np.zeros((wmax, M))
        pos = pos_core[i]
        rt = rt_tail[c]
        p = ports[i]
        if p < 0:
            finishes[i] = ready
            maximum(rt, ready, out=rt)
            rr[pos % wmax] = rt
            continue
        pid = cpid_l[i]
        pl = pipes[pid]
        if pl is None:
            w = width[:, p]
            pl = pipes[pid] = np.where(
                lane_arange[None, :int(w.max())] < w[:, None], 0.0,
                np.inf)
            hists[pid] = np.zeros((dmax[p], M))
        lane = pl.argmin(axis=1)           # first-min lane, = scalar's
        start = maximum(ready, pl[arange_m, lane])
        maximum(start, rr[rob_slot[pos], arange_m], out=start)
        h = hists[pid]
        qp = pos_cp[i]
        maximum(start, h[q_slot[p][qp], arange_m], out=start)
        finish = start + durs_cols[i]
        pl[arange_m, lane] = finish
        h[qp % dmax[p]] = start
        finishes[i] = finish
        maximum(rt, finish, out=rt)
        rr[pos % wmax] = rt
    cm = nc.costed_mask
    return np.max(finishes, axis=0, where=cm[:, None], initial=0.0)


def scan_structure(nb: NodeCompiledBatch, device):
    """The pass's knob-independent inputs as tensors on ``device``
    (``kernels.sched_scan.ScanStructure``), built once per batch form and
    device and cached on it."""
    from ..kernels import sched_scan
    device = str(device)
    cache = nb.__dict__.setdefault("_scan", {})
    st = cache.get(device)
    if st is None:
        cp = nb.nc.cp
        st = cache[device] = sched_scan.ScanStructure.build(
            cp.dep_indptr, cp.dep_indices, nb.edge_extra, cp.port_id,
            nb.sched_core_of, nb.pos_in_core, nb.pos_in_cp, nb.cpid,
            nb.n_streams, device)
    return st


def _node_pass_batch_torch(nb: NodeCompiledBatch, durs_cols: np.ndarray,
                           window: np.ndarray, width: np.ndarray,
                           depth: np.ndarray, device) -> np.ndarray:
    """:func:`_node_pass_batch` through ``kernels.sched_scan.node_scan``:
    the hand-written scan on a CUDA ``device``, its plain PyTorch version
    on the CPU; either replays the NumPy pass's float operations, so the
    result is bit-identical to it."""
    import torch

    from ..kernels import sched_scan
    M = len(window)
    if nb.nc.n == 0 or M == 0:
        return np.zeros(M)
    st = scan_structure(nb, device)
    t = sched_scan.node_scan(
        st, torch.from_numpy(np.ascontiguousarray(durs_cols)).to(st.device),
        *sched_scan.knob_tensors(window, width, depth, st.device))
    return t.cpu().numpy()


@dataclass
class NodeBatchResult:
    """Per-element results of a batched node run: contention-aware
    makespans, the zero-contention first pass, and each element's
    fixpoint pass count (``[M]`` arrays, one entry per knob combo /
    sweep cell)."""
    t_est: np.ndarray
    t_zero_contention: np.ndarray
    iterations: np.ndarray
    # passes actually run when knob dedup collapsed the grid (the
    # expanded ``iterations`` would overcount the bench's accounting)
    scheduled_passes: Optional[int] = None

    @property
    def total_scheduled_ops(self) -> int:
        """Op-instances actually scheduled: every fixpoint pass of every
        element is a full in-order schedule of the program (the bench's
        throughput accounting)."""
        if self.scheduled_passes is not None:
            return self.scheduled_passes
        return int(self.iterations.sum())


def _batch_context(nb: NodeCompiledBatch, n_cores: int,
                   nc: Optional[NodeCompiled] = None,
                   topo: Optional[NodeTopology] = None,
                   durs0: Optional[np.ndarray] = None) -> dict:
    """Fixpoint-state template for one (core count, spec) cell on ``nb``.
    Everything but ``n_active`` is read-only and shared across batch
    elements; use :func:`_clone_context` for each element's own state
    machine.  ``nc``/``topo``/``durs0`` override the batch form's own
    cost view for the spec-batched sweeps (DESIGN.md §19): the pass
    structure (streams, CSR edges, pipe ids) stays ``nb``'s, while the
    contention math and uncontended durations come from the per-spec
    view."""
    nc = nb.nc if nc is None else nc
    topo = nb.topo if topo is None else topo
    cores = np.arange(n_cores, dtype=np.int64)
    has_caps = any(nm in topo.shared_read_bw
                   or nm in topo.shared_write_bw
                   for nm in nc.level_names)
    n_active, active_per_dom = _work_domains(
        nc, n_cores, nb.shard, nb.sched_core_of, cores)
    return {"n_cores": n_cores, "cores": cores,
            "scale": (1.0 / n_cores) if nb.shard else 1.0,
            "contended": has_caps and n_cores > 1,
            "n_active": n_active, "active_per_dom": active_per_dom,
            "nc": nc, "topo": topo,
            "durs0": nc.cp.durations if durs0 is None else durs0}


def _clone_context(tmpl: dict) -> dict:
    """Per-element copy of a context template (fresh ``n_active``)."""
    return {**tmpl, "n_active": [a.copy() for a in tmpl["n_active"]]}


def _fixpoint_batch(nb: NodeCompiledBatch, contexts: List[dict],
                    knobs, max_iters: int, tol: float,
                    backend: str, device="cuda") -> NodeBatchResult:
    """The bandwidth-contention fixpoint as a vectorized outer loop over
    the batched pass: every element carries its own ``n_active`` state
    machine (replaying the scalar ``schedule_node`` trajectory exactly —
    same damping, same stop rules), elements drop out of the pass as
    they converge, and each pass schedules only the still-active
    columns.  Each context may carry its own cost view (``nc``/``topo``/
    ``durs0``, see :func:`_batch_context`), which is how the spec axis
    fuses with the knob axis.  ``backend="torch"`` runs each pass on
    ``device`` (``_node_pass_batch_torch``); the rest of the loop, the
    duration math included, stays NumPy on the host."""
    dev = check_backend(backend, device)
    M = knobs.batch
    n = nb.nc.n
    t_est = np.zeros(M)
    t_zero = np.zeros(M)
    iters = np.zeros(M, dtype=np.int64)
    if n == 0 or M == 0:
        return NodeBatchResult(t_est, t_zero, iters)
    if dev is None:
        pass_fn = _node_pass_batch
    else:
        def pass_fn(nb, durs_cols, window, width, depth):
            return _node_pass_batch_torch(nb, durs_cols, window, width,
                                          depth, dev)
    durs_cols = np.empty((n, M))
    done = np.zeros(M, dtype=bool)
    final = np.fromiter((not ctx["contended"] for ctx in contexts),
                        dtype=bool, count=M)
    stale = np.ones(M, dtype=bool)      # durations need (re)computing
    first = True
    while not done.all():
        active = ~done
        for m in np.nonzero(active & stale)[0]:
            ctx = contexts[m]
            nc_m = ctx["nc"]
            uncontended = all(float(a.max(initial=1.0)) <= 1.0
                              for a in ctx["n_active"])
            if uncontended and ctx["scale"] == 1.0:
                # exact path, same as the scalar engine's
                durs_cols[:, m] = ctx["durs0"]
            else:
                inv_r, inv_w = _eff_inv(nc_m, ctx["topo"], ctx["cores"],
                                        ctx["n_active"])
                row, row_w = (inv_r[0], inv_w[0]) if nb.shard else \
                    (inv_r[nb.sched_core_of], inv_w[nb.sched_core_of])
                durs_cols[:, m] = _contended_durs_arr(
                    nc_m, row, row_w, ctx["scale"])
            stale[m] = False
        # each pass schedules only the still-active columns
        idx = np.nonzero(active)[0]
        t_est[idx] = pass_fn(nb, durs_cols[:, idx], knobs.window[idx],
                             knobs.width[idx], knobs.depth[idx])
        iters[idx] += 1
        if first:
            t_zero[:] = t_est           # pass 1 runs every element
            first = False
        done |= active & final
        for m in np.nonzero(active & ~final)[0]:
            ctx = contexts[m]
            damp = 0.5 if iters[m] > 1 else 1.0
            ctx["n_active"], delta = _update_active(
                ctx["nc"], ctx["topo"], ctx["cores"], ctx["n_active"],
                nb.sched_core_of, nb.shard, ctx["scale"],
                ctx["n_cores"], float(t_est[m]), ctx["active_per_dom"],
                damp)
            if delta == 0.0:
                done[m] = True          # the pass just taken converged
            else:
                stale[m] = True
                final[m] = delta < tol or iters[m] >= max_iters
    return NodeBatchResult(t_est, t_zero, iters)


def schedule_node_batch(nc: NodeCompiled, hw: HardwareSpec, knobs,
                        n_cores: int,
                        topology: Optional[NodeTopology] = None,
                        partition: str = "shard",
                        core_of: Optional[np.ndarray] = None,
                        max_iters: int = 8, tol: float = 1e-2,
                        backend: str = "numpy",
                        device="cuda") -> NodeBatchResult:
    """Batched node engine: one contention-aware node estimate per knob
    combo in ``knobs`` (an :class:`~.compiled.O3Knobs` batch), all
    combos advancing in lockstep through the vectorized pass.  Each
    element is bit-identical to ``schedule_node`` under a spec carrying
    the same knobs, with ``backend="torch"`` too (each pass on ``device``:
    the scan kernel on a card, its plain version on the CPU).  Duplicate
    knob rows (clamp-collapsed grid points)
    are scheduled once and expanded back to the full grid."""
    uk, inv = knobs.unique()
    nb = compile_node_batch(nc, hw, n_cores, topology, partition, core_of)
    tmpl = _batch_context(nb, n_cores)
    contexts = [_clone_context(tmpl) for _ in range(uk.batch)]
    res = _fixpoint_batch(nb, contexts, uk, max_iters, tol, backend,
                          device)
    if uk is knobs:
        return res
    return NodeBatchResult(res.t_est[inv], res.t_zero_contention[inv],
                           res.iterations[inv],
                           scheduled_passes=res.total_scheduled_ops)


def schedule_node_sweep(nc: NodeCompiled, hw: HardwareSpec, knobs,
                        core_counts, topology: Optional[NodeTopology] = None,
                        partition: str = "shard", max_iters: int = 8,
                        tol: float = 1e-2,
                        backend: str = "numpy", device="cuda") -> np.ndarray:
    """Core-count x knob-grid sweep as one fused batch: ``t_est [C, B]``
    seconds.  Shard mode (the zoo's) shares one batch form across every
    core count — the whole sweep is a single ``C*B``-element run of the
    batched pass; op partitions fall back to one batch per count (their
    stream structure depends on the count)."""
    core_counts = list(core_counts)
    if partition == "shard":
        uk, inv = knobs.unique()       # dedup BEFORE tiling across counts
        B = uk.batch
        nb = compile_node_batch(nc, hw, max(core_counts), topology,
                                partition)
        tiled = O3Knobs(window=np.tile(uk.window, len(core_counts)),
                        width=np.tile(uk.width, (len(core_counts), 1)),
                        depth=np.tile(uk.depth, (len(core_counts), 1)))
        tmpls = {k: _batch_context(nb, k) for k in core_counts}
        contexts = [_clone_context(tmpls[k])
                    for k in core_counts for _ in range(B)]
        res = _fixpoint_batch(nb, contexts, tiled, max_iters, tol,
                              backend, device)
        return res.t_est.reshape(len(core_counts), B)[:, inv]
    rows = [schedule_node_batch(nc, hw, knobs, k, topology, partition,
                                max_iters=max_iters, tol=tol,
                                backend=backend, device=device).t_est
            for k in core_counts]
    return np.stack(rows)


# ----------------------------------------------------- spec-grid engine
_GRID_CACHE_SIZE = 4


@dataclass
class NodeGridCompiled:
    """One program compiled against a whole :class:`~.hwspec.SpecGrid`
    (DESIGN.md §19): the shared structural ``CompiledProgram`` (CSR
    def-use edges, port ids — spec-independent by the grid's uniformity
    contract), the spec-batched cost decomposition, per-spec
    ``NodeCompiled`` views into its columns, and the ``[n, S]``
    uncontended duration matrix.  ``schedule_spec_sweep`` fuses the S
    axis of one of these with the core-count and knob axes into a single
    batched fixpoint run."""
    grid: SpecGrid
    bc: BatchCosted
    cp: CompiledProgram           # structural form (spec-0 cost columns)
    views: List[NodeCompiled]     # per-spec cost views sharing ``cp``
    durations0: np.ndarray        # [n, S] uncontended (single-core) durs


def compile_node_grid(prog: Program, grid: SpecGrid,
                      links_per_collective: int = 2,
                      compute_dtype: Optional[str] = None
                      ) -> NodeGridCompiled:
    """Compile (and memoize on the Program) the spec-grid node form.

    One ``cost_program_batch`` pass covers every spec; the structural
    compile runs once, seeded with spec 0's cost column via the
    ``costed=`` bypass — so a grid compile never reads or writes the
    single-spec ``compile_program``/``compile_node`` caches (it cannot
    alias them; the grid cache is keyed by ``SpecGrid`` VALUE, a
    distinct key type).  Column ``s`` of every per-spec view is
    bit-identical to ``compile_node(prog, grid.specs[s])``'s arrays
    (pinned by the differential suite)."""
    cache = prog.__dict__.setdefault("_node_grid_cache", [])
    for cgrid, cdt, clk, cngc in cache:
        if cdt == compute_dtype and clk == links_per_collective \
                and cgrid == grid:
            return cngc
    bc = cost_program_batch(prog, grid, links_per_collective,
                            compute_dtype)
    n = bc.n
    costed0: List[Optional[OpTime]] = []
    for i, o in enumerate(prog.ops):
        if bc.port[i] is None:
            costed0.append(None)
        else:
            costed0.append(OpTime(o, float(bc.t_compute[i, 0]),
                                  float(bc.t_mem[i, 0]),
                                  float(bc.t_ici[i, 0]), bc.port[i]))
    cp = compile_program(prog, grid.specs[0], links_per_collective,
                         compute_dtype, costed=costed0)
    # (max(t_c, t_m, t_i) + startup) * count, the compile_program rule,
    # vectorized over the spec axis; uncharged ops stay zero-duration
    startup_s = np.array([sp.op_startup_ns for sp in grid.specs]) * 1e-9
    durations0 = (bc.t_op() + startup_s[None, :]) * bc.count[:, None]
    costed_mask = cp.port_id >= 0
    durations0[~costed_mask] = 0.0
    views: List[NodeCompiled] = []
    for s, sp in enumerate(grid.specs):
        levels = sp.memory_hierarchy()
        views.append(NodeCompiled(
            cp=cp, n=n,
            t_comp=np.ascontiguousarray(bc.t_compute[:, s]),
            t_ici=np.ascontiguousarray(bc.t_ici[:, s]),
            lat=np.ascontiguousarray(bc.latency[:, s]),
            count=bc.count,
            rd=np.ascontiguousarray(bc.rd[:, :, s]),
            wr=np.ascontiguousarray(bc.wr[:, :, s]),
            level_names=grid.level_names,
            core_read_bw=np.array([lv.read_bw for lv in levels]),
            core_write_bw=np.array([lv.write_bw for lv in levels]),
            shared_by=np.array([max(1, lv.shared_by) for lv in levels],
                               dtype=np.int64),
            startup=sp.op_startup_ns * 1e-9,
            costed_mask=costed_mask))
    ngc = NodeGridCompiled(grid=grid, bc=bc, cp=cp, views=views,
                           durations0=durations0)
    cache.append((grid, compute_dtype, links_per_collective, ngc))
    if len(cache) > _GRID_CACHE_SIZE:
        cache.pop(0)
    return ngc


def schedule_spec_sweep(ngc: NodeGridCompiled,
                        knobs: Optional[O3Knobs] = None,
                        core_counts=None, max_iters: int = 8,
                        tol: float = 1e-2,
                        backend: str = "numpy", device="cuda") -> np.ndarray:
    """Fused spec × core-count × knob sweep: ``t_est [S, C, B]``.

    Shard partition only (the DSE mode: every core runs the stream at
    ``1/n_cores`` work) — the pass structure is then one stream with no
    ring, shared by every spec, so the whole grid runs as a single
    ``S*C*B``-element batched contention fixpoint with each element's
    per-spec bandwidths/topology threaded through its own context.
    Every element is bit-identical to the per-spec scalar pipeline
    (``compile_node`` + ``schedule_node_batch``).

    ``core_counts``: ``None`` — each spec at its full topology core
    count (``C=1``); a sequence of ints — one shared count axis; a
    length-S sequence of per-spec sequences (all length C) — e.g. DSE
    grids where the core budget varies per candidate.  ``knobs``
    defaults to spec 0's O3 resources; duplicate rows are scheduled
    once."""
    grid = ngc.grid
    S = grid.S
    if knobs is None:
        knobs = O3Knobs.single(grid.specs[0])
    uk, inv = knobs.unique()
    B = uk.batch
    topos = [grid.topology_of(s) for s in range(S)]
    if core_counts is None:
        counts = [[t.n_cores] for t in topos]
    else:
        core_counts = list(core_counts)
        if core_counts and np.ndim(core_counts[0]) > 0:
            counts = [list(c) for c in core_counts]
            if len(counts) != S:
                raise ValueError("per-spec core_counts must have one "
                                 f"row per spec ({len(counts)} != {S})")
        else:
            counts = [list(core_counts)] * S
    C = len(counts[0])
    if any(len(c) != C for c in counts):
        raise ValueError("ragged core_counts (the sweep is [S, C, B])")
    # one shard structural form serves every (spec, count) cell
    nb = compile_node_batch(ngc.views[0], grid.specs[0], 1, topos[0],
                            "shard")
    contexts: List[dict] = []
    for s in range(S):
        for k in counts[s]:
            if k < 1 or k > max(topos[s].n_cores, 1):
                raise ValueError(f"n_cores={k} outside topology "
                                 f"{topos[s].name} "
                                 f"(max {topos[s].n_cores})")
            tmpl = _batch_context(nb, int(k), nc=ngc.views[s],
                                  topo=topos[s],
                                  durs0=ngc.durations0[:, s])
            contexts.extend(_clone_context(tmpl) for _ in range(B))
    tiled = O3Knobs(window=np.tile(uk.window, S * C),
                    width=np.tile(uk.width, (S * C, 1)),
                    depth=np.tile(uk.depth, (S * C, 1)))
    res = _fixpoint_batch(nb, contexts, tiled, max_iters, tol, backend,
                          device)
    return res.t_est.reshape(S, C, B)[:, :, inv]


def simulate_node(prog: Program, hw: HardwareSpec, n_cores: int,
                  topology: Optional[NodeTopology] = None,
                  partition: str = "round-robin",
                  links_per_collective: int = 2,
                  compute_dtype: Optional[str] = None,
                  costed: Optional[List[Optional[OpTime]]] = None,
                  **kw) -> NodeResult:
    """Cost + compile + node-schedule in one call (the ``simulate``
    entry point's ``engine="node"`` backend)."""
    nc = compile_node(prog, hw, links_per_collective, compute_dtype, costed)
    return schedule_node(nc, hw, n_cores, topology, partition, **kw)


def shard_costed(prog: Program, hw: HardwareSpec, n_cores: int,
                 topology: Optional[NodeTopology] = None,
                 links_per_collective: int = 2,
                 compute_dtype: Optional[str] = None
                 ) -> List[Optional[OpTime]]:
    """The shard-mode node model as a costed list: per-op times scaled by
    1/n_cores with the converged contention applied, suitable for
    ``compile_program(costed=...)`` — this is how the O3 knob sweep rides
    ``schedule_batch`` with core count as an extra grid axis (the knob
    grid batches over one shard-contended compiled program per core
    count)."""
    nc = compile_node(prog, hw, links_per_collective, compute_dtype)
    nr = schedule_node(nc, hw, n_cores, topology, partition="shard")
    topo = nr.topology
    cores = np.arange(n_cores, dtype=np.int64)
    # rebuild the converged per-level inverse bandwidths from the report
    n_active = []
    for li, nm in enumerate(nc.level_names):
        n_dom = int(np.ceil(n_cores / nc.shared_by[li]))
        na = np.ones(n_dom)
        for cs in nr.per_cmg:
            if nm in cs.n_active:
                na[:] = cs.n_active[nm]
                break
        n_active.append(na)
    inv_r, inv_w = _eff_inv(nc, topo, cores, n_active)
    scale = 1.0 / n_cores
    t_mem = ((nc.rd * inv_r[0]).sum(axis=1)
             + (nc.wr * inv_w[0]).sum(axis=1)) * scale + nc.lat
    base = cost_program(prog, hw, links_per_collective, compute_dtype)
    out: List[Optional[OpTime]] = []
    for i, ot in enumerate(base):
        if ot is None:
            out.append(None)
            continue
        out.append(dataclasses.replace(
            ot, t_compute=ot.t_compute * scale,
            t_mem=float(t_mem[i]) if ot.traffic is not None else 0.0,
            t_ici=ot.t_ici))
    return out
