"""The simulator's own in-order scan: one pass of the batched O3 list
scheduler over a compiled program, for M batch elements (knob combos x
duration rows) at once.

Counterpart of the reference's two jitted ``vmap(lax.scan)`` passes, which
are not Pallas kernels but were written so that "the simulator itself can
run on the accelerator it models": ``schedule_batch_jax``
(``repro.core.compiled``) and ``_node_pass_batch_jax`` (``repro.core.node``).
Both are one function here, ``node_scan``: ``core.node`` gives it S streams
(one per core) with the cross-CMG ring addend on the def-use edges;
``core.compiled.schedule_batch`` gives it one stream, positions in program
order and no addend.  Two versions of it live here:

* the CUDA kernel ``csrc/sched_scan.cu`` (built by ``_build``), launched for
  tensors on a CUDA device;
* ``node_scan_plain``, the same pass in plain PyTorch float64: a per-op
  loop over ``[M]`` vectors, line for line ``core.node._node_pass_batch``,
  used for tensors on the CPU and as the kernel's yardstick on the card.

The pass adds and takes maxima of float64 values and multiplies nothing,
and both versions replay the NumPy pass's operations in its order, so they
equal it bit for bit (not to a tolerance, as the reference's jax backends
did).  Dispatch is by the tensors' device and never falls back: a CUDA
tensor launches the kernel or raises.  ``node_scan.launches`` counts kernel
launches (``node_scan.elements`` the batch elements scheduled, by either
version).
``pointer_chase_ns`` times a dependent load (shared memory or
L2) on the card, the latency that bounds the scan's chain of ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import _build

PORTS = 4                 # core.compiled.PORTS: mxu, vpu, mem, ici
_I32 = torch.int32
_F64 = torch.float64


@dataclass(frozen=True)
class ScanStructure:
    """The pass's knob-independent inputs for one compiled program and
    partition, on ``device``: the CSR def-use edges (``indptr [n+1]``,
    ``indices [E]``, the optional ring addend ``edge_extra [E]``) and, per
    op, its port (-1 for a free op), stream, running position on its
    stream, position among the costed ops of its (stream, port) pipe and
    that pipe's id ``stream * PORTS + port``.  Tensors are int32 (float64
    for ``edge_extra``); the ``*_l`` lists mirror them on the host for the
    plain version's loop."""

    device: torch.device
    n: int
    n_streams: int
    max_core_ops: int             # most ops on one stream (free included)
    max_pipe_ops: int             # most costed ops on one (stream, port)
    pipe_counts: np.ndarray       # [S * PORTS] costed ops per pipe
    indptr: torch.Tensor
    indices: torch.Tensor
    edge_extra: Optional[torch.Tensor]
    port: torch.Tensor
    stream: torch.Tensor
    pos_in_core: torch.Tensor
    pos_in_cp: torch.Tensor
    cpid: torch.Tensor
    indptr_l: List[int]
    indices_l: List[int]
    extra_np: Optional[np.ndarray]
    port_l: List[int]
    stream_l: List[int]
    pos_core_l: List[int]
    pos_cp_l: List[int]
    cpid_l: List[int]

    @classmethod
    def build(cls, indptr, indices, edge_extra, port, stream, pos_in_core,
              pos_in_cp, cpid, n_streams: int, device) -> "ScanStructure":
        """From the NumPy arrays of ``core.compiled``/``core.node``."""
        device = torch.device(device)
        port = np.asarray(port, dtype=np.int64)
        stream = np.asarray(stream, dtype=np.int64)
        n = len(port)
        if n >= 2**31 or len(indices) >= 2**31:
            raise ValueError(f"{n} ops, {len(indices)} edges: the scan "
                             "indexes with int32")
        costed = port >= 0
        counts = np.bincount(stream[costed] * PORTS + port[costed],
                             minlength=n_streams * PORTS)
        core_ops = np.bincount(stream, minlength=n_streams)

        def i32(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(device)

        extra = None if edge_extra is None else np.asarray(edge_extra,
                                                           dtype=np.float64)
        return cls(
            device=device, n=n, n_streams=int(n_streams),
            max_core_ops=int(core_ops.max(initial=0)),
            max_pipe_ops=int(counts.max(initial=0)), pipe_counts=counts,
            indptr=i32(indptr), indices=i32(indices),
            edge_extra=None if extra is None
            else torch.from_numpy(extra).to(device),
            port=i32(port), stream=i32(stream), pos_in_core=i32(pos_in_core),
            pos_in_cp=i32(pos_in_cp), cpid=i32(cpid),
            indptr_l=np.asarray(indptr).tolist(),
            indices_l=np.asarray(indices).tolist(), extra_np=extra,
            port_l=port.tolist(), stream_l=stream.tolist(),
            pos_core_l=np.asarray(pos_in_core).tolist(),
            pos_cp_l=np.asarray(pos_in_cp).tolist(),
            cpid_l=np.asarray(cpid).tolist())


def knob_tensors(window, width, depth, device):
    """``O3Knobs`` columns (``window [M]``, ``width``/``depth [M, PORTS]``)
    as the int32 tensors the scan takes."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
                 .to(device) for a in (window, width, depth))


def _check(st: ScanStructure, durs, window, width, depth) -> int:
    M = window.shape[0]
    if durs.dim() != 2 or durs.shape != (st.n, M) or durs.dtype != _F64:
        raise ValueError(f"durs: want float64 [{st.n}, {M}], got "
                         f"{durs.dtype} {tuple(durs.shape)}")
    for what, t, shape in (("window", window, (M,)),
                           ("width", width, (M, PORTS)),
                           ("depth", depth, (M, PORTS))):
        if t.shape != shape or t.dtype != _I32 or not t.is_contiguous():
            raise ValueError(f"{what}: want contiguous int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if len({t.device for t in (durs, window, width, depth, st.indptr)}) != 1:
        raise ValueError("the scan's inputs are on different devices")
    if M and min(int(window.min()), int(width.min()), int(depth.min())) < 1:
        raise ValueError("window, width and depth must be at least 1")
    return M


def node_scan_plain(st: ScanStructure, durs: torch.Tensor,
                    window: torch.Tensor, width: torch.Tensor,
                    depth: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the scan, line for line the NumPy pass
    ``core.node._node_pass_batch``: every state array carries the batch as
    its last axis, rings are sized exactly ``max(window)`` and ``max(depth
    [:, p])`` so that a read ``window`` back before the ring filled hits a
    slot still at 0.0 (a no-op under max), and pipe lanes beyond an
    element's width hold +inf.  Returns ``t_est [M]``: the last finish over
    the costed ops, 0.0 where there is none."""
    M = _check(st, durs, window, width, depth)
    dev = durs.device
    n = st.n
    if n == 0 or M == 0:
        return torch.zeros(M, dtype=_F64, device=dev)
    P = PORTS
    S = st.n_streams
    indptr, indices, ports = st.indptr_l, st.indices_l, st.port_l
    extra, extra_np = st.edge_extra, st.extra_np
    core_l, pos_core, pos_cp, cpid_l = (st.stream_l, st.pos_core_l,
                                        st.pos_cp_l, st.cpid_l)
    window = window.long()
    width = width.long()
    depth = depth.long()
    arange_m = torch.arange(M, device=dev)
    zeros_m = torch.zeros(M, dtype=_F64, device=dev)       # read-only
    finishes = torch.empty((n, M), dtype=_F64, device=dev)
    wmax = int(window.max())
    rt_rings: List[Optional[torch.Tensor]] = [None] * S
    rt_tail = torch.zeros((S, M), dtype=_F64, device=dev)
    max_pos = max(st.max_core_ops, 1)
    # torch's % of a negative number by a positive one is non-negative,
    # as Python's and numpy's
    rob_slot = (torch.arange(max_pos, device=dev)[:, None]
                - window[None, :]) % wmax
    dmax = [max(1, int(d)) for d in depth.max(dim=0).values]
    q_slot: List[Optional[torch.Tensor]] = [None] * P
    for p in range(P):
        mq = int(st.pipe_counts[np.arange(S) * P + p].max(initial=0))
        if mq > 0:
            q_slot[p] = (torch.arange(mq, device=dev)[:, None]
                         - depth[None, :, p]) % dmax[p]
    pipes: List[Optional[torch.Tensor]] = [None] * (S * P)
    hists: List[Optional[torch.Tensor]] = [None] * (S * P)
    lane_arange = torch.arange(max(1, int(width.max())), device=dev)
    maximum = torch.maximum

    for i in range(n):
        lo = indptr[i]
        hi = indptr[i + 1]
        nd = hi - lo
        if nd == 1:
            j = indices[lo]
            if extra_np is None or extra_np[lo] == 0.0:
                ready = finishes[j]        # view; never written through
            else:
                ready = finishes[j] + extra[lo]
        elif nd == 0:
            ready = zeros_m
        else:
            dep_f = finishes[indices[lo:hi]]
            if extra_np is not None and extra_np[lo:hi].any():
                dep_f = dep_f + extra[lo:hi, None]
            ready = dep_f.amax(dim=0)
        c = core_l[i]
        rr = rt_rings[c]
        if rr is None:
            rr = rt_rings[c] = torch.zeros((wmax, M), dtype=_F64, device=dev)
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
            pl = pipes[pid] = torch.where(
                lane_arange[None, :int(w.max())] < w[:, None], 0.0,
                torch.inf).to(_F64)
            hists[pid] = torch.zeros((dmax[p], M), dtype=_F64, device=dev)
        lane = pl.argmin(dim=1)            # first-min lane, = numpy's
        start = maximum(ready, pl[arange_m, lane])
        maximum(start, rr[rob_slot[pos], arange_m], out=start)
        h = hists[pid]
        qp = pos_cp[i]
        maximum(start, h[q_slot[p][qp], arange_m], out=start)
        finish = start + durs[i]
        pl[arange_m, lane] = finish
        h[qp % dmax[p]] = start
        finishes[i] = finish
        maximum(rt, finish, out=rt)
        rr[pos % wmax] = rt
    costed = torch.tensor(ports, device=dev) >= 0
    return torch.where(costed[:, None], finishes, 0.0).amax(dim=0)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        lib = _build.load("sched_scan").lib
        raise RuntimeError(f"{what} kernel failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")


def node_scan(st: ScanStructure, durs: torch.Tensor, window: torch.Tensor,
              width: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """One in-order pass of M batch elements over the program of ``st``:
    ``durs [n, M]`` float64 (any strides: ``schedule_batch`` passes one
    duration column broadcast over M), ``window [M]``, ``width`` and
    ``depth [M, PORTS]`` int32.  Returns ``t_est [M]`` float64, bit-identical
    to the NumPy pass.  CPU tensors take ``node_scan_plain``; CUDA tensors
    launch the kernel (one thread a batch element) or raise."""
    device = durs.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"node_scan runs on cpu or cuda, not {device}")
    M = _check(st, durs, window, width, depth)
    node_scan.elements += M
    if device.type == "cpu":
        return node_scan_plain(st, durs, window, width, depth)
    out = torch.zeros(M, dtype=_F64, device=device)
    if st.n == 0 or M == 0:
        return out
    S, n = st.n_streams, st.n
    lanes = int(width.max())
    rob_slots, q_slots = _ring_slots(st, int(window.max()), int(depth.max()))
    finishes = torch.empty((n, M), dtype=_F64, device=device)
    rob = torch.empty((S, rob_slots, M), dtype=_F64, device=device)
    tail = torch.empty((S, M), dtype=_F64, device=device)
    pipes = torch.empty((S * PORTS, lanes, M), dtype=_F64, device=device)
    qring = torch.empty((S * PORTS, q_slots, M), dtype=_F64, device=device)
    lib = _build.load("sched_scan").lib
    extra = st.edge_extra
    events = node_scan.events
    if events is not None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    err = lib.repro_node_scan(
        st.indptr.data_ptr(), st.indices.data_ptr(),
        None if extra is None else extra.data_ptr(), st.port.data_ptr(),
        st.stream.data_ptr(), st.pos_in_core.data_ptr(),
        st.pos_in_cp.data_ptr(), st.cpid.data_ptr(), durs.data_ptr(),
        durs.stride(0), durs.stride(1), window.data_ptr(), width.data_ptr(),
        depth.data_ptr(), finishes.data_ptr(), rob.data_ptr(),
        tail.data_ptr(), pipes.data_ptr(), qring.data_ptr(), out.data_ptr(),
        n, M, S, lanes, rob_slots, q_slots,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "node_scan")
    node_scan.launches += 1
    if events is not None:
        e1.record()
        events.append((M, e0, e1))
    return out


# kernel launches; batch elements over the calls, kernel or plain
# (op-instances scheduled = n x elements); a list in ``events`` collects
# (M, start, end) CUDA events around each launch, for its device time
node_scan.launches = 0
node_scan.elements = 0
node_scan.events = None


def _ring_slots(st: ScanStructure, window_max: int, depth_max: int):
    """The kernel's ROB and reservation ring sizes: an entry is read
    ``window`` (``depth``) positions back, never more than a stream's
    (pipe's) length, so a ring of the smaller size serves."""
    return (max(1, min(window_max, st.max_core_ops)),
            max(1, min(depth_max, st.max_pipe_ops)))


def scan_bytes(st: ScanStructure, durs_cols: int, window, width,
               depth) -> int:
    """Bytes one launch must move, each read or written once: its inputs
    (the CSR edges and addend, five int32 per op, ``durs_cols`` columns of
    durations, the knobs ``window [M]``, ``width``/``depth [M, PORTS]``),
    ``finishes [n, M]``, its rings and pipes and ``t_est`` written."""
    E = len(st.indices_l)
    S = st.n_streams
    M = len(window)
    lanes = int(np.max(width))
    rob_slots, q_slots = _ring_slots(st, int(np.max(window)),
                                     int(np.max(depth)))
    inputs = (4 * (st.n + 1) + 4 * E + (8 * E if st.extra_np is not None
                                        else 0)
              + 5 * 4 * st.n + 8 * st.n * durs_cols
              + 4 * M * (1 + 2 * PORTS))
    state = 8 * M * (st.n + S * (rob_slots + 1)
                     + S * PORTS * (lanes + q_slots))
    return inputs + state + 8 * M


def pointer_chase_ns(level: str, device="cuda", hops: int = 1 << 16,
                     entries: int = 4096, seed: int = 0) -> float:
    """Nanoseconds of one dependent load on the card: one thread follows a
    random cycle of ``entries`` indices, in shared memory (``"shared"``) or
    in device memory spread one index a 128-byte line, read past the L1
    (``"l2"``: the cycle's 512 KiB stay in the 50 MB L2).  CUDA events
    around ``hops`` and ``2 * hops`` hops; the difference over ``hops``
    leaves out the launch."""
    if level not in ("shared", "l2"):
        raise ValueError(f"level is 'shared' or 'l2', not {level!r}")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("pointer_chase_ns times the card")
    stride = 1 if level == "shared" else 32           # int32s a line
    order = np.random.default_rng(seed).permutation(entries)
    nxt = np.zeros(entries * stride, dtype=np.int32)
    nxt[order * stride] = np.roll(order, -1) * stride
    buf = torch.from_numpy(nxt).to(device)
    sink = torch.zeros(1, dtype=_I32, device=device)
    lib = _build.load("sched_scan").lib
    cuda_stream = torch.cuda.current_stream(device).cuda_stream

    def run(k):
        err = lib.repro_sched_chase(int(level == "l2"), buf.data_ptr(),
                                    entries * stride, k, sink.data_ptr(),
                                    cuda_stream)
        _raise_on(err, "pointer chase")

    run(hops)                                          # warm: L2, clocks
    times = []
    for k in (hops, 2 * hops):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run(k)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) * 1e6)      # ns
    return (times[1] - times[0]) / hops
