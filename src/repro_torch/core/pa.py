"""PA-data-style report — the paper's Fujitsu-profiler analogue.

A copy of ``repro.core.pa``.

The RIKEN simulator classified 0-instruction-commit cycles into memory wait /
arithmetic wait / etc., counted SIMD elements honouring the predicate
register, and exposed cycle-by-cycle OoO resource utilization.  The HLO-level
equivalents:

  * stall classification  -> exposed (non-overlapped) time per port,
  * predicate-aware SIMD  -> MXU useful-lane fraction (tile-padding waste),
  * OoO utilization       -> per-port busy fraction + per-opclass time,
  * tuning hints          -> rule-based "what moves the dominant term down".
"""
from __future__ import annotations

from typing import List, Optional

from .engine import EngineResult
from .hlo import Program
from .node import NodeResult
from .roofline import Roofline
from .schedule import ScheduleResult


def _fmt_t(s: float) -> str:
    if s >= 1.0:
        return f"{s:8.3f} s "
    if s >= 1e-3:
        return f"{s * 1e3:8.3f} ms"
    return f"{s * 1e6:8.3f} us"


def suggestions(rf: Roofline, eng: EngineResult, prog: Program) -> List[str]:
    out = []
    dom = rf.dominant
    comm = prog.comm_by_collective()
    if dom == "collective":
        top = max(comm, key=lambda k: comm[k]) if comm else "all-gather"
        if top == "all-gather":
            out.append("collective-bound, all-gather dominant: params are "
                       "re-gathered per step — raise per-device batch, widen "
                       "FSDP axis only across faster links, or overlap via "
                       "async collectives / looped collective-einsum.")
        elif top == "all-reduce":
            out.append("collective-bound, all-reduce dominant: compress "
                       "gradients (int8 error-feedback), accumulate more "
                       "microbatches per sync, or move the reduction to a "
                       "reduce-scatter + local update (ZeRO).")
        else:
            out.append(f"collective-bound ({top}): reshard to cut payload or "
                       "use hierarchical (intra-pod first) groups.")
    elif dom == "memory":
        out.append("HBM-bound: increase arithmetic intensity — fuse "
                   "elementwise chains (bigger fusions), cast activations to "
                   "bf16, raise per-device batch, or re-tile kernels so the "
                   "working set stays VMEM-resident.")
    else:
        if rf.mxu_utilization < 0.7:
            out.append(f"compute-bound with MXU useful-lane fraction "
                       f"{rf.mxu_utilization:.2f}: pad/align matmul dims to "
                       f"128 (vocab/heads/d_ff shard sizes).")
        if rf.useful_flops_ratio < 0.45:
            out.append(f"MODEL_FLOPS/HLO_FLOPs = {rf.useful_flops_ratio:.2f}: "
                       "compiled compute is mostly non-model work — check "
                       "remat policy (recompute), routing dispatch, or "
                       "attention masking waste.")
        if not out:
            out.append("compute-bound at good utilization: this cell is near "
                       "roofline; gains must come from algorithm (sparsity, "
                       "lower precision).")
    return out


def _fmt_bytes(b: float) -> str:
    if b >= 2**30:
        return f"{b / 2**30:8.2f} GiB"
    if b >= 2**20:
        return f"{b / 2**20:8.2f} MiB"
    return f"{b / 2**10:8.2f} KiB"


def _memory_section(eng: EngineResult) -> List[str]:
    """Per-level traffic/residency — the paper's cache-hierarchy function
    expansion made visible: where each op's reads and writes were served."""
    tot = sum(a["read_bytes"] + a["write_bytes"]
              for a in eng.traffic_by_level.values())
    if tot <= 0:
        return []
    lines = ["  memory hierarchy (routed traffic | residency):"]
    for name, a in sorted(eng.traffic_by_level.items(),
                          key=lambda kv: -(kv[1]["read_bytes"]
                                           + kv[1]["write_bytes"])):
        share = (a["read_bytes"] + a["write_bytes"]) / tot
        lines.append(f"    {name:<6s} read {_fmt_bytes(a['read_bytes'])}  "
                     f"write {_fmt_bytes(a['write_bytes'])}  "
                     f"({100 * share:5.1f}% of traffic)")
    return lines


def _schedule_section(sched: ScheduleResult) -> List[str]:
    """Critical-path + per-port timeline view of the O3 schedule — the
    paper's cycle-by-cycle OoO resource utilization, at HLO altitude."""
    lines = []
    mk = max(sched.t_est, 1e-30)
    lines.append("  schedule engine (dependency-aware O3):")
    lines.append(f"    estimate: {_fmt_t(sched.t_est)}   dataflow critical "
                 f"path: {_fmt_t(sched.t_dataflow)}   serial: "
                 f"{_fmt_t(sched.t_serial)}")
    lines.append(f"    overlap from schedule: {100 * sched.overlap_fraction:.1f}%"
                 f" of serial hidden   ({sched.n_edges} def-use edges)")
    lines.append("    port timeline (busy | util of makespan):")
    for port in ("mxu", "vpu", "mem", "ici"):
        if port not in sched.port_busy:
            continue
        busy = sched.port_busy[port]
        lines.append(f"      {port:<4s} {_fmt_t(busy)}  "
                     f"({100 * busy / mk:5.1f}%)")
    if sched.stall_by_reason:
        stalls = "  ".join(f"{k}:{_fmt_t(v).strip()}"
                           for k, v in sorted(sched.stall_by_reason.items(),
                                              key=lambda kv: -kv[1]))
        lines.append(f"    issue stalls beyond data-ready: {stalls}")
    cp = sched.critical_path
    if cp:
        covered = sum(c.duration for c in cp)
        trunc = (" — TRUNCATED: binding chain longer than "
                 f"{len(cp)} entries, shown path is a suffix"
                 if sched.critical_path_truncated else "")
        lines.append(f"    critical path ({len(cp)} ops, "
                     f"{100 * covered / mk:.0f}% of makespan{trunc}):")
        for c in cp[-12:]:
            lines.append(f"      {c.op.name[:40]:<40s} {c.port:<4s} "
                         f"start {_fmt_t(c.start)}  dur "
                         f"{_fmt_t(c.duration)}  <- {c.bound_by}")
    return lines


def _node_section(node: NodeResult) -> List[str]:
    """Per-CMG contention/occupancy — the node engine's view: how many
    cores were concurrently streaming through each shared level, and the
    per-core effective bandwidth that left each of them."""
    lines = []
    lines.append(f"  node engine ({node.n_cores} cores, "
                 f"partition={node.partition}, topology="
                 f"{node.topology.name}):")
    lines.append(f"    estimate: {_fmt_t(node.t_est)}   zero-contention "
                 f"bound: {_fmt_t(node.t_zero_contention)}   "
                 f"dataflow: {_fmt_t(node.schedule.t_dataflow)}")
    lines.append(f"    parallel efficiency: "
                 f"{100 * node.parallel_efficiency:.1f}%   contention "
                 f"fixpoint: {node.iterations} iteration(s)")
    for g in node.per_cmg:
        if not g.n_active:
            lines.append(f"    cmg{g.cmg}: {g.n_cores} cores  "
                         f"occupancy {100 * g.occupancy:5.1f}%  "
                         f"(no shared-level caps)")
            continue
        cont = "  ".join(
            f"{lv}: {g.n_active[lv]:.1f} active, "
            f"{g.eff_read_bw[lv] / 1e9:.0f}/"
            f"{g.eff_write_bw[lv] / 1e9:.0f} GB/s/core"
            for lv in sorted(g.n_active))
        lines.append(f"    cmg{g.cmg}: {g.n_cores} cores  occupancy "
                     f"{100 * g.occupancy:5.1f}%  {cont}")
    if node.per_core:
        slow = max(node.per_core, key=lambda c: c.t_finish)
        fast = min(node.per_core, key=lambda c: c.t_finish)
        lines.append(f"    imbalance: core{slow.core} finishes at "
                     f"{_fmt_t(slow.t_finish)} vs core{fast.core} at "
                     f"{_fmt_t(fast.t_finish)}")
    return lines


def pa_report(rf: Roofline, eng: EngineResult, prog: Program,
              title: str = "", sched: Optional[ScheduleResult] = None,
              engine_mode: str = "occupancy",
              node: Optional[NodeResult] = None) -> str:
    lines = []
    lines.append(f"== PA report {title} ==")
    # headline matches SimReport.t_est: node-derived in node mode,
    # schedule-derived in schedule mode, occupancy otherwise (labelled
    # when several numbers are in the report)
    if engine_mode == "node" and node is not None:
        lines.append(f"  estimate (node, {node.n_cores} cores): "
                     f"{_fmt_t(node.t_est)}   occupancy (1 core): "
                     f"{_fmt_t(eng.t_est)}   zero-contention: "
                     f"{_fmt_t(node.t_zero_contention)}")
    elif engine_mode == "schedule" and sched is not None:
        lines.append(f"  estimate (schedule): {_fmt_t(sched.t_est)}   "
                     f"occupancy: {_fmt_t(eng.t_est)}   roofline-bound: "
                     f"{_fmt_t(eng.t_roofline)}   serial: "
                     f"{_fmt_t(eng.t_serial)}")
    else:
        label = "estimate (occupancy)" if sched is not None else "estimate"
        lines.append(f"  {label}: {_fmt_t(eng.t_est)}   roofline-bound: "
                     f"{_fmt_t(eng.t_roofline)}   serial: "
                     f"{_fmt_t(eng.t_serial)}")
    lines.append(f"  roofline terms: compute {_fmt_t(rf.compute_s)} | memory "
                 f"{_fmt_t(rf.memory_s)} | collective {_fmt_t(rf.collective_s)}"
                 f"  -> dominant: {rf.dominant}")
    lines.append(f"  MODEL/HLO flops: {rf.useful_flops_ratio:.3f}   "
                 f"MXU useful-lane: {rf.mxu_utilization:.3f}")
    lines.append("  port busy:")
    tot = max(eng.t_est, 1e-30)
    for port in ("mxu", "vpu", "mem", "ici"):
        t = eng.port_busy.get(port, 0.0)
        lines.append(f"    {port:<4s} {_fmt_t(t)}  ({100 * t / tot:5.1f}% of est)")
    lines.extend(_memory_section(eng))
    lines.append("  time by opclass:")
    for cls, t in sorted(eng.by_class_time.items(), key=lambda kv: -kv[1]):
        lines.append(f"    {cls:<16s} {_fmt_t(t)}")
    if eng.collective_time_by_kind:
        lines.append("  collectives:")
        comm = prog.comm_by_collective()
        for k, t in sorted(eng.collective_time_by_kind.items(),
                           key=lambda kv: -kv[1]):
            lines.append(f"    {k:<20s} {_fmt_t(t)}  payload/dev "
                         f"{comm.get(k, 0) / 2**20:9.1f} MiB")
    if sched is not None:
        lines.extend(_schedule_section(sched))
    if node is not None:
        lines.extend(_node_section(node))
    lines.append("  hints:")
    for s in suggestions(rf, eng, prog):
        lines.append(f"    - {s}")
    return "\n".join(lines)
