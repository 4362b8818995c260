"""Compiled array-form scheduling core — the simulator's hot path, SoA.

A copy of ``repro.core.compiled``.  The reference's ``schedule_batch_jax``
(``backend="jax"``, a jitted ``lax.scan``) becomes ``backend="torch"``:
``kernels.sched_scan.node_scan`` with one stream, the hand-written scan on
a card, bit-identical to the NumPy pass.

``schedule_program`` was a pure-Python per-op interpreter over ``OpStat``
dataclasses (~75k scheduled ops/s on the kernel-suite bench).  The paper's
whole premise is that a tuned pipeline simulator must be *fast enough* to
sweep OoO resource parameters against a test chip — so the costed program
is compiled ONCE per ``(Program, HardwareSpec, dtype)`` into a
structure-of-arrays :class:`CompiledProgram` (durations, port ids, CSR
def-use edges, packed O3 knobs) and every downstream consumer runs on it:

* :func:`schedule_arrays` — the fast scalar kernel: ``t_est`` /
  ``port_busy`` / ``stall_by_reason`` with zero ``ScheduledOp``
  allocations (the knob-independent invariants ``t_serial`` /
  ``t_dataflow`` / ``port_busy`` / ``n_edges`` are precomputed at compile
  time and simply carried),
* :func:`schedule_batch` — the batched sweep engine: the whole O3 knob
  grid is a batch axis; one sequential pass over the ops advances every
  knob combination in lockstep with NumPy vector ops, so enlarging the
  grid (windows up to 1024, per-port widths) is ~free,
* ``schedule_batch(backend="torch")`` — the same in-order list scheduler
  as a CUDA kernel (``kernels.sched_scan``), so the simulator itself can
  run on the card it models.

Every kernel replays the reference scheduler's float operations in the
same order, so ``t_est`` is bit-identical to ``core.schedule``'s
interpreter — asserted by the differential tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost import OpTime, cost_program
from .hlo import Program
from .hwspec import HardwareSpec

# global port-id mapping; core.cost only ever emits these four
PORTS: Tuple[str, ...] = ("mxu", "vpu", "mem", "ici")
_PORT_ID = {p: i for i, p in enumerate(PORTS)}
_COMPILE_CACHE_SIZE = 8


@dataclass
class O3Knobs:
    """A batch of packed O3 knob combinations (the grid's batch axis)."""
    window: np.ndarray           # [B] int64, already clamped >= 1
    width: np.ndarray            # [B, len(PORTS)] int64, clamped >= 1
    depth: np.ndarray            # [B, len(PORTS)] int64, clamped >= 1

    @property
    def batch(self) -> int:
        return len(self.window)

    @classmethod
    def from_specs(cls, specs: Sequence[HardwareSpec]) -> "O3Knobs":
        b = len(specs)
        window = np.empty(b, dtype=np.int64)
        width = np.empty((b, len(PORTS)), dtype=np.int64)
        depth = np.empty((b, len(PORTS)), dtype=np.int64)
        for i, hw in enumerate(specs):
            window[i] = max(1, hw.inflight_window)
            for p, pid in _PORT_ID.items():
                width[i, pid] = max(1, hw.issue_width.get(p, 1))
                depth[i, pid] = max(1, hw.queue_depth.get(p, 1))
        return cls(window, width, depth)

    @classmethod
    def single(cls, hw: HardwareSpec) -> "O3Knobs":
        return cls.from_specs([hw])

    @classmethod
    def from_grid(cls, hw: HardwareSpec,
                  combos: Sequence[Tuple[int, int, int, int]]) -> "O3Knobs":
        """Pack a (window, mem_width, vpu_width, queue_depth) grid around
        ``hw``'s remaining knobs WITHOUT materializing a HardwareSpec per
        combo (the sweep's grid is just integers)."""
        b = len(combos)
        window = np.empty(b, dtype=np.int64)
        width = np.empty((b, len(PORTS)), dtype=np.int64)
        depth = np.empty((b, len(PORTS)), dtype=np.int64)
        for p, pid in _PORT_ID.items():
            width[:, pid] = max(1, hw.issue_width.get(p, 1))
        for i, (w, mw, vw, qd) in enumerate(combos):
            window[i] = max(1, w)
            width[i, _PORT_ID["mem"]] = max(1, mw)
            width[i, _PORT_ID["vpu"]] = max(1, vw)
            depth[i, :] = max(1, qd)
        return cls(window, width, depth)

    def unique(self) -> Tuple["O3Knobs", np.ndarray]:
        """Deduplicated knob rows + the inverse map back to the full grid.

        The ``max(1, ·)`` clamps in the constructors collapse distinct
        grid points into identical combos (e.g. every window <= 1), and
        batched sweeps would schedule those rows redundantly.  Returns
        ``(uk, inv)`` with ``uk`` in FIRST-OCCURRENCE order (so argmin
        tie-breaking downstream matches the undeduped grid) and
        ``full_result = unique_result[inv]``.  Identity (``self``,
        arange) when every row is already distinct.
        """
        b = self.batch
        rows = np.concatenate(
            [self.window[:, None], self.width, self.depth], axis=1)
        _, first, inv = np.unique(rows, axis=0, return_index=True,
                                  return_inverse=True)
        inv = inv.reshape(-1)          # numpy 2.x keeps the extra axis
        if len(first) == b:
            return self, np.arange(b)
        # np.unique sorts rows; restore first-occurrence order
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        sel = first[order]
        return (O3Knobs(self.window[sel], self.width[sel], self.depth[sel]),
                rank[inv])


@dataclass
class CompiledProgram:
    """Structure-of-arrays form of one costed program.

    Arrays are aligned with ``Program.ops``; ops the cost model does not
    charge carry ``port_id == -1`` and zero duration (they still occupy a
    ROB slot and propagate readiness, exactly like the interpreter).
    Everything the O3 knobs canNOT change is precomputed here once:
    ``t_serial``, ``t_dataflow``, ``port_busy``, ``n_ops``, ``n_edges``.
    """
    n: int
    durations: np.ndarray        # [n] f64: (max(t_c,t_m,t_i)+startup)*count
    port_id: np.ndarray          # [n] int8 into PORTS; -1 = uncosted
    dep_indptr: np.ndarray       # [n+1] CSR over valid (j < i) edges
    dep_indices: np.ndarray      # [E]
    pos_in_port: np.ndarray      # [n] running issue index on the op's port
    port_counts: np.ndarray      # [len(PORTS)] ops issued per port
    # knob-independent schedule invariants
    t_serial: float
    t_dataflow: float
    n_ops: float
    n_edges: int
    port_busy: Dict[str, float]
    knobs: O3Knobs               # packed from the compiling HardwareSpec
    # python-list mirrors (scalar kernel: list indexing beats ndarray)
    _dur_l: list = field(default_factory=list, repr=False)
    _port_l: list = field(default_factory=list, repr=False)
    _indptr_l: list = field(default_factory=list, repr=False)
    _indices_l: list = field(default_factory=list, repr=False)


def compile_program(prog: Program, hw: HardwareSpec,
                    links_per_collective: int = 2,
                    compute_dtype: Optional[str] = None,
                    costed: Optional[List[Optional[OpTime]]] = None
                    ) -> CompiledProgram:
    """Compile (and memoize on the Program) the SoA form.

    The cache is keyed by ``(hw VALUE, dtype, links)``: the frozen spec
    compares by field values, so an O3-knob sweep that rebuilds a
    value-equal spec (``dataclasses.replace`` / ``with_`` round trips)
    still hits the cache and the grid shares one CompiledProgram.  Specs
    that differ in any field get their own entry (durations could differ
    via ``op_startup_ns``).

    A caller-supplied ``costed`` list bypasses the cache entirely (no
    lookup, no store): the caller may have edited the costs, and the key
    cannot see that.
    """
    if costed is None:
        cache = prog.__dict__.setdefault("_compiled_cache", [])
        for chw, cdt, clk, ccp in cache:
            if cdt == compute_dtype and clk == links_per_collective \
                    and chw == hw:
                return ccp
        costed = cost_program(prog, hw, links_per_collective, compute_dtype)
    else:
        cache = None

    n = len(prog.ops)
    startup = hw.op_startup_ns * 1e-9
    durations = np.zeros(n, dtype=np.float64)
    port_id = np.full(n, -1, dtype=np.int8)
    pos_in_port = np.zeros(n, dtype=np.int64)
    port_counts = np.zeros(len(PORTS), dtype=np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    indices: List[int] = []
    port_busy: Dict[str, float] = {}
    t_serial = 0.0
    n_ops = 0.0
    n_edges = 0

    for i, ot in enumerate(costed):
        o = prog.ops[i]
        for j in o.deps:
            if 0 <= j < i:
                indices.append(j)
        indptr[i + 1] = len(indices)
        if ot is None:
            continue
        # same float-op order as the interpreter: per-instance max + startup,
        # times the (loop-trip) count
        dur = (max(ot.t_compute, ot.t_mem, ot.t_ici) + startup) * o.count
        pid = _PORT_ID[ot.port]
        durations[i] = dur
        port_id[i] = pid
        pos_in_port[i] = port_counts[pid]
        port_counts[pid] += 1
        port_busy[ot.port] = port_busy.get(ot.port, 0.0) + dur
        t_serial += dur
        n_ops += o.count
        n_edges += int(indptr[i + 1] - indptr[i])

    # pure dataflow critical path (infinite resources lower bound) is
    # knob-independent: precompute once
    length = [0.0] * n
    idx_l = indices
    ptr_l = indptr.tolist()
    dur_l = durations.tolist()
    for i in range(n):
        best = 0.0
        for k in range(ptr_l[i], ptr_l[i + 1]):
            v = length[idx_l[k]]
            if v > best:
                best = v
        length[i] = dur_l[i] + best
    t_dataflow = max(length, default=0.0)

    cp = CompiledProgram(
        n=n, durations=durations, port_id=port_id,
        dep_indptr=indptr, dep_indices=np.array(indices, dtype=np.int64),
        pos_in_port=pos_in_port, port_counts=port_counts,
        t_serial=t_serial, t_dataflow=t_dataflow, n_ops=n_ops,
        n_edges=n_edges, port_busy=port_busy,
        knobs=O3Knobs.single(hw),
        _dur_l=dur_l, _port_l=port_id.tolist(),
        _indptr_l=ptr_l, _indices_l=idx_l,
    )
    if cache is not None:
        cache.append((hw, compute_dtype, links_per_collective, cp))
        if len(cache) > _COMPILE_CACHE_SIZE:
            cache.pop(0)
    return cp


# ------------------------------------------------------- fast scalar kernel
def schedule_arrays(cp: CompiledProgram, hw: HardwareSpec
                    ) -> Tuple[float, Dict[str, float]]:
    """One knob combination, no timeline: returns ``(t_est,
    stall_by_reason)``.  Bit-identical to the interpreter (same max/add
    sequence; the port 'heap' degenerates to min-of-list, which sees the
    same multiset of pipe-free times)."""
    widths = [max(1, hw.issue_width.get(p, 1)) for p in PORTS]
    depths = [max(1, hw.queue_depth.get(p, 1)) for p in PORTS]
    window = max(1, hw.inflight_window)

    durs = cp._dur_l
    ports = cp._port_l
    indptr = cp._indptr_l
    indices = cp._indices_l
    n = cp.n
    finishes = [0.0] * n
    rt = [0.0] * n
    rt_prev = 0.0
    pipes: List[Optional[List[float]]] = [None] * len(PORTS)
    hist: List[List[float]] = [[] for _ in PORTS]
    s_port = s_window = s_queue = 0.0
    t_est = 0.0

    for i in range(n):
        ready = 0.0
        for k in range(indptr[i], indptr[i + 1]):
            f = finishes[indices[k]]
            if f > ready:
                ready = f
        p = ports[i]
        if p < 0:
            # free op: propagate readiness through it at zero cost
            finishes[i] = ready
            if ready > rt_prev:
                rt_prev = ready
            rt[i] = rt_prev
            continue
        pl = pipes[p]
        if pl is None:
            pl = pipes[p] = [0.0] * widths[p]
        start = ready
        why = 0
        pf = min(pl)
        if pf > start:
            start, why = pf, 1
        if i >= window:
            wt = rt[i - window]
            if wt > start:
                start, why = wt, 2
        h = hist[p]
        d = depths[p]
        if len(h) >= d:
            qt = h[-d]
            if qt > start:
                start, why = qt, 3
        finish = start + durs[i]
        pl[pl.index(pf)] = finish
        h.append(start)
        finishes[i] = finish
        if finish > rt_prev:
            rt_prev = finish
        rt[i] = rt_prev
        if finish > t_est:
            t_est = finish
        if start > ready:
            d_t = start - ready
            if why == 1:
                s_port += d_t
            elif why == 2:
                s_window += d_t
            else:
                s_queue += d_t

    stall: Dict[str, float] = {}
    if s_port > 0:
        stall["port"] = s_port
    if s_window > 0:
        stall["window"] = s_window
    if s_queue > 0:
        stall["queue"] = s_queue
    return t_est, stall


# ------------------------------------------------------ batched numpy kernel
def schedule_batch(cp: CompiledProgram, knobs: O3Knobs,
                   backend: str = "numpy", device="cuda") -> np.ndarray:
    """Schedule every knob combination in ``knobs`` against the shared
    compiled program in ONE sequential pass over the ops (the knob grid is
    the vector axis of every state update).  Returns ``t_est`` per combo,
    bit-identical to running the scalar kernel per combination.
    ``backend="torch"`` runs the pass on ``device`` (default ``cuda``,
    which raises without a card): the scan kernel on a card, its plain
    PyTorch version on the CPU; bit-identical to ``"numpy"``."""
    dev = check_backend(backend, device)
    uk, inv = knobs.unique()
    if uk is not knobs:               # clamped grids alias rows: schedule
        return schedule_batch(cp, uk, backend, device)[inv]  # each once
    if dev is not None:
        return _schedule_batch_torch(cp, knobs, dev)
    B = knobs.batch
    n = cp.n
    t_est = np.zeros(B, dtype=np.float64)
    if n == 0 or B == 0:
        return t_est
    arange_b = np.arange(B)
    window = knobs.window
    finishes = np.zeros((n, B), dtype=np.float64)
    rt = np.zeros((n, B), dtype=np.float64)
    rt_prev = np.zeros(B, dtype=np.float64)
    # per-port pipes, padded to the batch's max width; lanes beyond a
    # combo's width start at +inf so min/argmin never picks them
    pipes: List[Optional[np.ndarray]] = [None] * len(PORTS)
    # per-port issue-start history: the op->port mapping is knob-independent,
    # so each port's history rows line up across the whole batch
    hist = [np.empty((int(c), B), dtype=np.float64) for c in cp.port_counts]
    hist_len = [0] * len(PORTS)

    indptr = cp.dep_indptr
    indices = cp.dep_indices
    ports = cp._port_l
    durs = cp._dur_l

    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        if hi > lo:
            ready = finishes[indices[lo:hi]].max(axis=0)
        else:
            ready = np.zeros(B, dtype=np.float64)
        p = ports[i]
        if p < 0:
            finishes[i] = ready
            np.maximum(rt_prev, ready, out=rt_prev)
            rt[i] = rt_prev
            continue
        pl = pipes[p]
        if pl is None:
            w = knobs.width[:, p]
            pl = np.where(np.arange(int(w.max()))[None, :] < w[:, None],
                          0.0, np.inf)
            pipes[p] = pl
        start = ready.copy()
        pf = pl.min(axis=1)
        np.maximum(start, pf, out=start)
        if i >= 1:
            idx = i - window
            valid = idx >= 0
            if valid.any():
                wt = np.where(valid, rt[np.clip(idx, 0, None), arange_b], 0.0)
                np.maximum(start, wt, out=start)
        h = hist[p]
        qidx = hist_len[p] - knobs.depth[:, p]
        qvalid = qidx >= 0
        if qvalid.any():
            qt = np.where(qvalid, h[np.clip(qidx, 0, None), arange_b], 0.0)
            np.maximum(start, qt, out=start)
        finish = start + durs[i]
        lane = pl.argmin(axis=1)
        pl[arange_b, lane] = finish
        h[hist_len[p]] = start
        hist_len[p] += 1
        finishes[i] = finish
        np.maximum(rt_prev, finish, out=rt_prev)
        rt[i] = rt_prev
        np.maximum(t_est, finish, out=t_est)
    return t_est


# ------------------------------------------------------- the scan on a card
def check_backend(backend: str, device):
    """The batched passes' backends: ``"numpy"`` (returns None) or
    ``"torch"``, the scan kernel (returns ``device`` resolved: ``cuda``
    raises without a card).  The reference's ``"jax"`` is not the port's."""
    if backend == "jax":
        raise ValueError("backend='jax' is the reference's jitted scan; the "
                         "port's scan on the card is backend='torch'")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown schedule backend {backend!r}: 'numpy' "
                         "or 'torch'")
    if backend == "numpy":
        return None
    from ..device import resolve
    return resolve(device)


def scan_structure(cp: CompiledProgram, device):
    """``cp`` as the scan's one-stream structure on ``device``: positions
    in program order, each costed op's position on its port, no ring
    addend (``kernels.sched_scan.ScanStructure``); cached on ``cp``."""
    from ..kernels import sched_scan
    device = str(device)
    cache = cp.__dict__.setdefault("_scan", {})
    st = cache.get(device)
    if st is None:
        port = cp.port_id.astype(np.int64)
        st = cache[device] = sched_scan.ScanStructure.build(
            cp.dep_indptr, cp.dep_indices, None, port,
            np.zeros(cp.n, dtype=np.int64), np.arange(cp.n),
            cp.pos_in_port, np.maximum(port, 0), 1, device)
    return st


def _schedule_batch_torch(cp: CompiledProgram, knobs: O3Knobs,
                          device) -> np.ndarray:
    """``schedule_batch``'s pass through ``kernels.sched_scan.node_scan``:
    one duration column, broadcast over the knob batch (stride 0)."""
    import torch

    from ..kernels import sched_scan
    B = knobs.batch
    if cp.n == 0 or B == 0:
        return np.zeros(B, dtype=np.float64)
    st = scan_structure(cp, device)
    durs = torch.from_numpy(cp.durations).to(st.device)[:, None].expand(
        cp.n, B)
    t = sched_scan.node_scan(st, durs, *sched_scan.knob_tensors(
        knobs.window, knobs.width, knobs.depth, st.device))
    return t.cpu().numpy()
