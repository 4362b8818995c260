"""Multi-level memory-hierarchy model — the paper's "function expansion".

A copy of ``repro.core.memory`` (no JAX; the port's tests hold it bit for bit
against the reference).

The RIKEN simulator's accuracy came from expanding gem5's memory system
into the A64FX's real hierarchy (L1D with asymmetric load/store ports —
>230 vs >115 GB/s per core — an 8 MiB L2, HBM2) and then tuning each
level's parameters against the test chip.  This module is that expansion
at HLO altitude:

* a ``HardwareSpec`` carries an ordered hierarchy of ``MemLevel``s
  (innermost/fastest first: L1/VMEM -> L2 -> HBM), each with its own
  capacity, asymmetric read/write bandwidth, and access latency;
* per-op traffic is *routed* to a level by a reuse-distance/working-set
  residency model driven by the def-use edges the parser records:

  - **dep reads** (operand has a known producer): the reuse distance is
    the bytes written to the hierarchy between producer and consumer
    (prefix sums of per-instance write bytes).  The operand is charged at
    the innermost level whose capacity covers that distance — data
    produced "recently enough" is still level-resident.
  - **cold reads** (parameters, constants) and **writes**: on machines
    with hardware-managed caches (``warm_caches=True``: the A64FX, the
    CPU host) they are charged at the innermost level that holds the
    op's whole working set (read + write bytes) — the steady-state
    warm-cache rule.  On scratch-memory machines (TPU VMEM is software-
    managed; weights genuinely stream from HBM every step) they are
    charged at the outermost level, and only def-use reuse earns
    inner-level bandwidth.

* reads and writes are split (``OpStat.read_bytes`` / ``write_bytes``),
  so the asymmetric load/store paths finally matter: a store-heavy op on
  ``A64FX_CORE`` is slower than its load-heavy mirror, and halving
  ``hbm_write_bw`` slows store-bound programs.

The router is pure python over already-parsed programs; it knows nothing
about engines.  ``core.cost`` turns routed traffic into per-op times that
both the occupancy and the schedule engine consume.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .hlo import OpStat, Program


@dataclass(frozen=True)
class MemLevel:
    """One level of the hierarchy (the gem5 cache/memobj parameter file).

    ``read_bw``/``write_bw`` are the *per-core* paths (what one core can
    draw through the level alone).  ``shared_by`` is the size of the
    sharing domain in a node (1 = core-private, 12 = one A64FX CMG's L2/
    HBM2): the node engine (``core.node``) divides the domain's aggregate
    bandwidth — carried by ``NodeTopology`` — among the cores actively
    streaming through the level.  Single-core engines ignore it.
    """
    name: str
    capacity: float              # bytes held at this level
    read_bw: float               # bytes/s toward the core (load path)
    write_bw: float              # bytes/s away from the core (store path)
    latency_s: float = 0.0       # access latency, charged once per op
                                 # at the deepest level the op touches
    shared_by: int = 1           # cores sharing this level in a node


@dataclass
class MemTraffic:
    """Per-op routed traffic: bytes and time per hierarchy level.

    Bytes are per *instance* (not multiplied by ``OpStat.count``) and
    already dtype-normalized (DESIGN.md §7), matching the other per-op
    time components.
    """
    read_by_level: Dict[str, float] = field(default_factory=dict)
    write_by_level: Dict[str, float] = field(default_factory=dict)
    t_read: float = 0.0
    t_write: float = 0.0
    latency_s: float = 0.0

    @property
    def t_mem(self) -> float:
        return self.t_read + self.t_write + self.latency_s


def _dtype_scale(op: OpStat, compute_dtype: Optional[str]) -> float:
    """Inverted XLA:CPU float-normalization (DESIGN.md §7): f32 traffic is
    costed at 16-bit width when the model computes in bf16/f16."""
    if compute_dtype in ("bf16", "f16") and op.dtype == "f32":
        return 0.5
    return 1.0


def _split_rw(op: OpStat, scale: float) -> Tuple[float, float]:
    """Effective (read, write) bytes.  Synthetic OpStats built with only
    ``bytes_accessed`` (tests, sweeps) are treated as pure reads, which
    reproduces the old scalar model exactly."""
    if op.read_bytes or op.write_bytes:
        return op.read_bytes * scale, op.write_bytes * scale
    return op.bytes_accessed * scale, 0.0


def residency_level(levels: Sequence[MemLevel], nbytes: float) -> MemLevel:
    """Innermost level whose capacity covers ``nbytes`` (outermost level
    backstops everything — there is nowhere further to miss to)."""
    for lv in levels:
        if nbytes <= lv.capacity:
            return lv
    return levels[-1]


def stream_time(levels: Sequence[MemLevel], nbytes: float,
                write: bool = False) -> float:
    """Time to stream a ``nbytes`` working set through the hierarchy at
    its residency level's bandwidth: the level is picked by
    :func:`residency_level` (innermost fit, outermost backstop), so a
    working set that spills a level pays the next level's bandwidth.

    This is the serving simulator's KV-cache cost hook (``core.serving``,
    DESIGN.md §21): a decode batch whose cache working set no longer fits
    L2 streams from HBM2, and one that outgrows HBM2 still streams at the
    outermost level's bandwidth (there is nowhere further to miss to).
    """
    if nbytes <= 0:
        return 0.0
    lv = residency_level(levels, nbytes)
    bw = lv.write_bw if write else lv.read_bw
    return nbytes / bw


def route_standalone(op: OpStat, levels: Sequence[MemLevel],
                     compute_dtype: Optional[str] = None,
                     warm_caches: bool = False) -> MemTraffic:
    """Route one op with no program context: no producer information, so
    everything takes the cold-read/write rule (working set if the caches
    are hardware-managed and warm, outermost level otherwise)."""
    scale = _dtype_scale(op, compute_dtype)
    rb, wb = _split_rw(op, scale)
    lv = (residency_level(levels, rb + wb) if warm_caches else levels[-1])
    tr = MemTraffic()
    _charge(tr, lv, rb, wb)
    tr.latency_s = lv.latency_s
    return tr


def _charge(tr: MemTraffic, lv: MemLevel, rb: float, wb: float) -> None:
    if rb > 0:
        tr.read_by_level[lv.name] = tr.read_by_level.get(lv.name, 0.0) + rb
        tr.t_read += rb / lv.read_bw
    if wb > 0:
        tr.write_by_level[lv.name] = tr.write_by_level.get(lv.name, 0.0) + wb
        tr.t_write += wb / lv.write_bw


def _route_edges(prog: Program, compute_dtype: Optional[str]):
    """Spec-independent routing inputs, computed once per program: the
    effective (read, write) bytes per op, the budget-clamped CSR def-use
    edge shares, and each edge's reuse distance.  None of these depend on
    level capacities or bandwidths, so the spec-batched router
    (:func:`route_program_batch`) shares them across the whole grid.
    Returns ``(rb, wb, dst, e_eff, dist)``.  A program with exact dtypes
    is not de-normalized (``Program.denorm_dtype``)."""
    n = len(prog.ops)
    compute_dtype = prog.denorm_dtype(compute_dtype)
    scales = [_dtype_scale(o, compute_dtype) for o in prog.ops]
    rws = [_split_rw(o, scales[i]) for i, o in enumerate(prog.ops)]
    rb = np.array([r for r, _ in rws], dtype=np.float64)
    wb = np.array([w for _, w in rws], dtype=np.float64)
    # foot[i] = effective bytes written by ops 0..i-1
    foot = np.zeros(n + 1, dtype=np.float64)
    np.cumsum(wb, out=foot[1:])

    # CSR def-use edge list (consumer-major, edges in OpStat.deps order)
    srcs: List[int] = []
    dsts: List[int] = []
    ebts: List[float] = []
    indptr = np.zeros(n + 1, dtype=np.intp)
    for i, o in enumerate(prog.ops):
        sc = scales[i]
        for j, b in zip(o.deps, o.dep_bytes):
            if 0 <= j < i and b > 0:
                srcs.append(j)
                dsts.append(i)
                ebts.append(b * sc)
        indptr[i + 1] = len(srcs)
    src = np.array(srcs, dtype=np.intp)
    dst = np.array(dsts, dtype=np.intp)
    eb = np.array(ebts, dtype=np.float64)

    # dep reads by reuse distance; shares clamped to the read budget
    # (slice/DUS refinements can make boundary reads smaller than the
    # nominal operand sizes the edges carry)
    total_share = np.bincount(dst, weights=eb,
                              minlength=n).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        shrink = np.where((total_share > rb) & (rb > 0),
                          rb / np.where(total_share > 0, total_share, 1.0),
                          1.0)
    e_shr = eb * shrink[dst]
    # sequential budget clamp, prefix-sum form: edge k of op i gets
    # min(share_k, budget_i - sum of earlier shares of i)
    cs = np.concatenate(([0.0], np.cumsum(e_shr)))
    prev_within = cs[:-1] - cs[indptr[dst]]
    e_eff = np.clip(np.minimum(e_shr, rb[dst] - prev_within), 0.0, None)
    e_eff[rb[dst] <= 0] = 0.0

    dist = foot[dst] - foot[src]
    return rb, wb, dst, e_eff, dist


def route_program(prog: Program, levels: Sequence[MemLevel],
                  compute_dtype: Optional[str] = None,
                  warm_caches: bool = False) -> List[MemTraffic]:
    """Route every op's traffic through the hierarchy.

    Reuse distances are computed on the per-iteration op sequence: prefix
    sums of per-instance write bytes, so an edge from op *j* to op *i* sees
    the footprint written by ops *j..i-1* (including *j*'s own output —
    an operand larger than a level can never be resident there).  Edges
    that cross a collapsed loop body (count > 1) use the single-iteration
    footprint, a deliberate under-estimate recorded in DESIGN.md §12.

    Vectorized (DESIGN.md §13): one array pass over the CSR def-use edge
    list instead of a per-op/per-edge Python loop — the residency lookup
    becomes a ``searchsorted`` on the (cumulative-max) level capacities,
    the read-budget clamp a prefix-sum formulation, the per-level byte
    tallies ``np.add.at`` scatters.
    """
    if not levels:
        raise ValueError("empty memory hierarchy")
    n = len(prog.ops)
    if n == 0:
        return []
    L = len(levels)
    # residency_level scans innermost-out and takes the first fit, so a
    # (pathological) smaller-capacity outer level can never win: the
    # running max reproduces first-fit exactly under searchsorted
    caps = np.maximum.accumulate(
        np.array([lv.capacity for lv in levels], dtype=np.float64))
    read_bw = np.array([lv.read_bw for lv in levels], dtype=np.float64)
    write_bw = np.array([lv.write_bw for lv in levels], dtype=np.float64)
    lat = np.array([lv.latency_s for lv in levels], dtype=np.float64)

    rb, wb, dst, e_eff, dist = _route_edges(prog, compute_dtype)

    # cold-traffic level: warm working-set rule on cache machines,
    # outermost (HBM/DRAM) on scratch-memory machines
    if warm_caches:
        cold = np.minimum(np.searchsorted(caps, rb + wb, side="left"), L - 1)
    else:
        cold = np.full(n, L - 1, dtype=np.intp)

    elvl = np.minimum(np.searchsorted(caps, dist, side="left"), L - 1)

    dep_read = np.bincount(dst, weights=e_eff,
                           minlength=n).astype(np.float64)
    t_read = np.bincount(dst, weights=e_eff / read_bw[elvl],
                         minlength=n).astype(np.float64)
    leftover = np.clip(rb - dep_read, 0.0, None)
    has_cold_read = leftover > 0
    t_read += np.where(has_cold_read, leftover / read_bw[cold], 0.0)
    t_write = np.where(wb > 0, wb / write_bw[cold], 0.0)

    # deepest level touched (latency is charged there once per op)
    deepest = np.where(wb > 0, cold, 0)
    live = e_eff > 0
    np.maximum.at(deepest, dst[live], elvl[live])
    deepest = np.where(has_cold_read, np.maximum(deepest, cold), deepest)
    latency = lat[deepest]

    # per-(op, level) byte tallies for the PA hierarchy section
    rbl = np.zeros((n, L), dtype=np.float64)
    np.add.at(rbl, (dst[live], elvl[live]), e_eff[live])
    rbl[has_cold_read, cold[has_cold_read]] += leftover[has_cold_read]

    names = [lv.name for lv in levels]
    out: List[MemTraffic] = []
    for i in range(n):
        tr = MemTraffic(t_read=float(t_read[i]), t_write=float(t_write[i]),
                        latency_s=float(latency[i]))
        row = rbl[i]
        for k in range(L):
            if row[k] > 0:
                tr.read_by_level[names[k]] = float(row[k])
        if wb[i] > 0:
            tr.write_by_level[names[cold[i]]] = float(wb[i])
        out.append(tr)
    return out


# ------------------------------------------------- spec-batched routing
@dataclass
class BatchTraffic:
    """Spec-batched routed traffic: ``[n_ops, S]`` times and
    ``[n_ops, L, S]`` per-level bytes over a grid of S hierarchies
    (DESIGN.md §19).  Column ``s`` is bit-identical to
    :func:`route_program` under hierarchy ``s`` (the differential suite
    pins it); bytes are per instance and dtype-normalized, like
    :class:`MemTraffic`.
    """
    level_names: Tuple[str, ...]
    t_read: np.ndarray           # [n, S]
    t_write: np.ndarray          # [n, S]
    latency: np.ndarray          # [n, S]
    read_by_level: np.ndarray    # [n, L, S]
    write_by_level: np.ndarray   # [n, L, S]

    @property
    def t_mem(self) -> np.ndarray:
        """[n, S]; same add order as :meth:`MemTraffic.t_mem`."""
        return self.t_read + self.t_write + self.latency


def route_program_batch(prog: Program,
                        levels_per_spec: Sequence[Sequence[MemLevel]],
                        compute_dtype: Optional[str] = None,
                        warm_caches: bool = False) -> BatchTraffic:
    """Route every op through S hierarchies at once (the spec batch axis).

    The spec-independent inputs — effective read/write bytes, the
    budget-clamped def-use edge shares, reuse distances — are computed
    once (:func:`_route_edges`); only the residency lookups, bandwidth
    divisions and per-level tallies grow a trailing S axis.  The
    ``searchsorted``-over-cummax residency trick becomes a broadcast
    ``(caps < v).sum()`` count (identical for sorted capacities), and the
    per-``dst`` time accumulations use ``np.add.at``, which adds in edge
    order exactly like the scalar path's ``np.bincount`` — so every
    column is bit-identical to a :func:`route_program` call with that
    spec's levels.  All hierarchies must share depth and level names
    (structural uniformity; numeric parameters are free to vary).
    """
    if not levels_per_spec:
        raise ValueError("empty spec grid")
    names = tuple(lv.name for lv in levels_per_spec[0])
    L = len(names)
    if L == 0:
        raise ValueError("empty memory hierarchy")
    for levels in levels_per_spec:
        if tuple(lv.name for lv in levels) != names:
            raise ValueError(
                "spec grid hierarchies must share level structure: "
                f"{tuple(lv.name for lv in levels)} != {names}")
    S = len(levels_per_spec)
    n = len(prog.ops)
    if n == 0:
        z2 = np.zeros((0, S))
        return BatchTraffic(names, z2, z2.copy(), z2.copy(),
                            np.zeros((0, L, S)), np.zeros((0, L, S)))
    # [S, L] level parameter matrices (capacities cummax'd per spec row)
    caps = np.maximum.accumulate(np.array(
        [[lv.capacity for lv in levels] for levels in levels_per_spec],
        dtype=np.float64), axis=1)
    read_bw = np.array([[lv.read_bw for lv in levels]
                        for levels in levels_per_spec], dtype=np.float64)
    write_bw = np.array([[lv.write_bw for lv in levels]
                         for levels in levels_per_spec], dtype=np.float64)
    lat = np.array([[lv.latency_s for lv in levels]
                    for levels in levels_per_spec], dtype=np.float64)
    s_idx = np.arange(S)[None, :]

    rb, wb, dst, e_eff, dist = _route_edges(prog, compute_dtype)
    E = len(dst)

    # residency: count of levels whose (cummax) capacity is < v ==
    # searchsorted(caps, v, side="left") per spec column
    if warm_caches:
        cold = np.minimum(
            (caps[None, :, :] < (rb + wb)[:, None, None]).sum(axis=2),
            L - 1)                                   # [n, S]
    else:
        cold = np.full((n, S), L - 1, dtype=np.intp)
    elvl = np.minimum(
        (caps[None, :, :] < dist[:, None, None]).sum(axis=2), L - 1)

    t_read = np.zeros((n, S))
    if E:
        rbw_e = read_bw[s_idx, elvl]                 # [E, S]
        np.add.at(t_read, dst, e_eff[:, None] / rbw_e)
    dep_read = np.bincount(dst, weights=e_eff,
                           minlength=n).astype(np.float64)
    leftover = np.clip(rb - dep_read, 0.0, None)
    has_cold_read = leftover > 0
    t_read += np.where(has_cold_read[:, None],
                       leftover[:, None] / read_bw[s_idx, cold], 0.0)
    t_write = np.where(wb[:, None] > 0,
                       wb[:, None] / write_bw[s_idx, cold], 0.0)

    # deepest level touched (latency charged there once per op)
    deepest = np.where(wb[:, None] > 0, cold, 0)
    live = e_eff > 0
    if live.any():
        np.maximum.at(deepest, dst[live], elvl[live])
    deepest = np.where(has_cold_read[:, None],
                       np.maximum(deepest, cold), deepest)
    latency = lat[s_idx, deepest]

    # per-(op, level, spec) byte tallies (flat-index scatters: the level
    # index varies per spec column, so the scatter target does too)
    rbl = np.zeros((n, L, S))
    flat_s = np.arange(S)[None, :]
    if live.any():
        fl = (dst[live][:, None] * L + elvl[live]) * S + flat_s
        np.add.at(rbl.reshape(-1), fl, e_eff[live][:, None])
    rows = np.nonzero(has_cold_read)[0]
    if len(rows):
        fl = (rows[:, None] * L + cold[rows]) * S + flat_s
        np.add.at(rbl.reshape(-1), fl, leftover[rows][:, None])
    wbl = np.zeros((n, L, S))
    rows = np.nonzero(wb > 0)[0]
    if len(rows):
        fl = (rows[:, None] * L + cold[rows]) * S + flat_s
        np.add.at(wbl.reshape(-1), fl, wb[rows][:, None])

    return BatchTraffic(names, t_read, t_write, latency, rbl, wbl)


def aggregate_traffic(traffic: Sequence[Optional[MemTraffic]],
                      counts: Sequence[float]) -> Dict[str, Dict[str, float]]:
    """Program-level per-level totals (bytes and time, count-multiplied)
    for the PA report's hierarchy section."""
    agg: Dict[str, Dict[str, float]] = {}
    for tr, c in zip(traffic, counts):
        if tr is None:
            continue
        for kind in ("read", "write"):
            by = tr.read_by_level if kind == "read" else tr.write_by_level
            for name, b in by.items():
                a = agg.setdefault(name, {"read_bytes": 0.0,
                                          "write_bytes": 0.0})
                a[f"{kind}_bytes"] += b * c
    return agg
