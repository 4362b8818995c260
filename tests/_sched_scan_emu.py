"""``csrc/sched_scan.cu``'s indexing, replayed in Python on the CPU.

The scan kernel runs only on a card.  This emulation walks the same flat
arrays with the same layouts as the kernel (element index fastest), the
same ring sizes (``min(window, ops on the stream)`` and ``min(depth, ops
on the pipe)``), the same explicit ``pos >= window`` tests, one pipe lane
count for every port and the same chunked staging of ops and edges
(``kChunk`` ops, at most ``kEdges`` edges, an op with more edges read
directly), so that the CPU tests hold the kernel's design, not only its
plain version, against the NumPy pass.
"""
import math

import numpy as np

K_PORTS = 4
K_CHUNK = 64
K_EDGES = 1024


def emulate(st, durs, window, width, depth, k_chunk=K_CHUNK,
            k_edges=K_EDGES):
    """``t_est [M]`` as ``node_scan``'s kernel computes it, from a
    ``ScanStructure`` and NumPy ``durs [n, M]``, ``window [M]``,
    ``width``/``depth [M, 4]``."""
    n, M, S = st.n, len(window), st.n_streams
    if n == 0 or M == 0:
        return np.zeros(M)
    indptr, indices, extra = st.indptr_l, st.indices_l, st.extra_np
    lanes = int(width.max())
    rob_slots = max(1, min(int(window.max()), st.max_core_ops))
    q_slots = max(1, min(int(depth.max()), st.max_pipe_ops))
    fin = [0.0] * (n * M)
    rob = [None] * (S * rob_slots * M)     # a read before a write raises
    tail = [0.0] * (S * M)
    pipes = [0.0] * (S * K_PORTS * lanes * M)
    qring = [None] * (S * K_PORTS * q_slots * M)
    for m in range(M):
        for s in range(S):
            for p in range(K_PORTS):
                for lane in range(lanes):
                    pipes[((s * K_PORTS + p) * lanes + lane) * M + m] = (
                        0.0 if lane < width[m, p] else math.inf)
    out = [0.0] * M
    base = 0
    while base < n:
        e0 = indptr[base]
        cnt = sum(1 for t in range(k_chunk)
                  if base + t < n and indptr[base + t + 1] - e0 <= k_edges)
        direct = cnt == 0
        cnt = max(cnt, 1)
        ptr = [0] + [indptr[base + t + 1] - e0 for t in range(cnt)]
        for m in range(M):
            win = int(window[m])
            for q in range(cnt):
                i = base + q
                ready = 0.0
                ks = (range(indptr[i], indptr[i + 1]) if direct
                      else range(e0 + ptr[q], e0 + ptr[q + 1]))
                for k in ks:
                    f = fin[indices[k] * M + m]
                    if extra is not None:
                        f += extra[k]
                    ready = f if f > ready else ready
                s, p, pos = st.stream_l[i], st.port_l[i], st.pos_core_l[i]
                tl = s * M + m
                rb = s * rob_slots * M + m
                if p < 0:
                    fin[i * M + m] = ready
                    tail[tl] = max(tail[tl], ready)
                    rob[rb + (pos % rob_slots) * M] = tail[tl]
                    continue
                pid, qp = st.cpid_l[i], st.pos_cp_l[i]
                pl = pid * lanes * M + m
                qr = pid * q_slots * M + m
                best, lane = pipes[pl], 0
                for lane_i in range(1, lanes):
                    if pipes[pl + lane_i * M] < best:
                        best, lane = pipes[pl + lane_i * M], lane_i
                start = max(ready, best)
                if pos >= win:
                    start = max(start, rob[rb + ((pos - win) % rob_slots) * M])
                d = int(depth[m, p])
                if qp >= d:
                    start = max(start, qring[qr + ((qp - d) % q_slots) * M])
                f = start + float(durs[i, m])
                pipes[pl + lane * M] = f
                qring[qr + (qp % q_slots) * M] = start
                fin[i * M + m] = f
                tail[tl] = max(tail[tl], f)
                rob[rb + (pos % rob_slots) * M] = tail[tl]
                out[m] = max(out[m], f)
        base += cnt
    return np.array(out)
