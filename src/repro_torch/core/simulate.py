"""Top-level simulator API: program -> SimReport.

    report = simulate(hlo_text, hw=H100, compute_dtype="f32", engine="both")
    print(report.pa)

A copy of ``repro.core.simulate`` without JAX: the input is HLO text, an
already parsed or hand-built :class:`~.hlo.Program`, or a PyTorch step
captured as an ATen graph (``core.aten.capture``: a ``torch.fx.GraphModule``
goes through ``aten.parse_graph`` as the reference's jax ``Compiled`` goes
through its HLO text), so ``xla_cost_analysis`` and ``memory_analysis``
are ``None``.

This is the paper's end-to-end flow: application binary -> simulator ->
execution-cycle estimate + PA data, before the target hardware exists.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

from .cost import cost_program
from .engine import EngineResult, simulate_program
from .hlo import Program, parse_program
from .hwspec import HardwareSpec, NodeTopology, TPU_V5E
from .node import NodeResult, simulate_node
from .pa import pa_report
from .roofline import Roofline, roofline_from_program
from .sample import SampledNodeResult, SamplingConfig, sampled_schedule_node
from .schedule import ScheduleResult, schedule_program


@dataclass
class SimReport:
    """Everything ``simulate()`` produced for one compiled program:
    roofline terms (DESIGN.md §6), the engine result(s), program summary,
    the rendered PA report, and the parsed ``program`` for re-costing.
    """
    hw: str
    n_chips: int
    roofline: Roofline
    engine: EngineResult
    program_summary: Dict[str, Any]
    pa: str
    xla_cost_analysis: Optional[Dict[str, float]] = None
    memory_analysis: Optional[Dict[str, float]] = None
    # dependency-aware O3 schedule (engine="schedule"|"both"); None for the
    # fast flat-occupancy path
    schedule: Optional[ScheduleResult] = None
    engine_mode: str = "occupancy"
    # the parsed per-op program (not serialized in to_json) so callers can
    # re-cost/re-schedule without re-parsing the HLO text
    program: Optional[Program] = None
    # multi-core node engine result (engine="node")
    node: Optional[NodeResult] = None
    # sampled node estimation (engine="node" + sampling=; DESIGN.md §18)
    sampled: Optional[SampledNodeResult] = None

    @property
    def t_est(self) -> float:
        """Headline estimate: sampled-node or node-derived in node mode,
        schedule-derived when the O3 engine ran as the primary mode,
        flat-occupancy otherwise (both always carried)."""
        if self.engine_mode == "node" and self.sampled is not None:
            return self.sampled.t_est
        if self.engine_mode == "node" and self.node is not None:
            return self.node.t_est
        if self.engine_mode == "schedule" and self.schedule is not None:
            return self.schedule.t_est
        return self.engine.t_est

    def to_json(self) -> str:
        d = {
            "hw": self.hw,
            "n_chips": self.n_chips,
            "roofline": self.roofline.as_dict(),
            "engine": {
                "t_est": self.engine.t_est,
                "t_roofline": self.engine.t_roofline,
                "t_serial": self.engine.t_serial,
                "port_busy": self.engine.port_busy,
                "by_class_time": self.engine.by_class_time,
                "collective_time_by_kind": self.engine.collective_time_by_kind,
                "n_ops": self.engine.n_ops,
                "mxu_utilization": self.engine.mxu_utilization,
                "traffic_by_level": self.engine.traffic_by_level,
            },
            "program": self.program_summary,
            "xla_cost_analysis": self.xla_cost_analysis,
            "memory_analysis": self.memory_analysis,
            "engine_mode": self.engine_mode,
        }
        if self.schedule is not None:
            s = self.schedule
            d["schedule"] = {
                "t_est": s.t_est,
                "t_roofline": s.t_roofline,
                "t_serial": s.t_serial,
                "t_dataflow": s.t_dataflow,
                "port_busy": s.port_busy,
                "overlap_fraction": s.overlap_fraction,
                "n_edges": s.n_edges,
                "stall_by_reason": s.stall_by_reason,
                "critical_path_truncated": s.critical_path_truncated,
                "critical_path": [
                    {"op": c.op.name, "port": c.port, "start": c.start,
                     "finish": c.finish, "bound_by": c.bound_by}
                    for c in s.critical_path[:32]],
            }
        if self.node is not None:
            nr = self.node
            d["node"] = {
                "t_est": nr.t_est,
                "n_cores": nr.n_cores,
                "partition": nr.partition,
                "topology": nr.topology.name,
                "t_zero_contention": nr.t_zero_contention,
                "iterations": nr.iterations,
                "parallel_efficiency": nr.parallel_efficiency,
                "t_serial": nr.schedule.t_serial,
                "t_dataflow": nr.schedule.t_dataflow,
                "port_busy": nr.schedule.port_busy,
                "stall_by_reason": nr.schedule.stall_by_reason,
                "per_cmg": [
                    {"cmg": g.cmg, "n_cores": g.n_cores,
                     "n_active": g.n_active,
                     "eff_read_bw": g.eff_read_bw,
                     "eff_write_bw": g.eff_write_bw,
                     "occupancy": g.occupancy}
                    for g in nr.per_cmg],
            }
        if self.sampled is not None:
            sm = self.sampled
            d["sampled"] = {
                "t_est": sm.t_est,
                "n_cores": sm.n_cores,
                "partition": sm.partition,
                "k": sm.plan.k,
                "n_intervals": sm.plan.n_intervals,
                "interval_ops": sm.plan.config.interval_ops,
                "seed": sm.plan.config.seed,
                "frac_ops_scheduled": sm.frac_ops_scheduled,
                "t_zero_contention": sm.t_zero_contention,
                "bound_by": sm.bound_by,
                "port_busy": sm.port_busy,
                "traffic_by_level": sm.traffic_by_level,
            }
        return json.dumps(d, indent=1, sort_keys=True)


def simulate(program: Union[str, Program, Any], hw: HardwareSpec = TPU_V5E,
             n_chips: int = 1, model_flops_global: float = 0.0,
             compute_dtype: str = "bf16", title: str = "",
             engine: str = "occupancy", n_cores: int = 1,
             topology: Optional[NodeTopology] = None,
             node_partition: str = "round-robin",
             sampling: Optional[SamplingConfig] = None) -> SimReport:
    """Simulate one program on ``hw``: the paper's end-to-end flow
    (application binary -> execution-time estimate + PA data, DESIGN.md §2).

    ``program`` is HLO text (parsed once under the DESIGN.md §9
    byte-accounting rules), a :class:`~.hlo.Program`, or a captured
    ``torch.fx.GraphModule`` (parsed by ``aten.parse_graph`` under its
    restatement of those rules for eager ATen, with exact dtypes).  It is
    costed once through the unified cost pipeline and memory hierarchy
    (DESIGN.md §3/§12); every engine shares that costed list.

    ``engine`` selects the overlap model:
      * ``"occupancy"`` (default) — the flat multi-port sum with assumed
        ``dma_overlap``/``ici_overlap`` fractions; fastest.
      * ``"schedule"``  — the dependency-aware O3 list scheduler
        (``core.schedule``): overlap is derived from the def-use graph and
        the hw issue/window/queue knobs; ``report.t_est`` comes from it.
      * ``"both"``      — run both; ``t_est`` stays occupancy-derived, the
        schedule rides along in ``report.schedule`` for comparison.
      * ``"node"``      — the multi-core node engine (``core.node``): the
        program runs on ``n_cores`` cores of ``topology`` (default: the
        spec's own, else a degenerate contention-free one) under
        ``node_partition`` ("round-robin" | "graph" | "shard");
        ``report.t_est`` is the contention-aware node makespan and the PA
        report gains the per-CMG contention section.

    ``sampling`` (node mode only) switches the node estimate to the
    SimPoint-style sampled path (``core.sample``, DESIGN.md §18): the
    program is sliced into intervals, clustered by signature, and only
    cluster representatives are scheduled; ``report.sampled`` carries the
    reconstruction and ``report.t_est`` comes from it.  Use for long
    traces (full-depth steps, multi-token decode) where scheduling every
    op is the bottleneck.

    Returns a :class:`SimReport`; ``report.pa`` is the human-readable PA
    report, ``report.to_json()`` the machine-readable artifact.
    """
    if engine not in ("occupancy", "schedule", "both", "node"):
        raise ValueError(f"unknown engine mode {engine!r}")
    if sampling is not None and engine != "node":
        raise ValueError("sampling= requires engine='node'")
    if isinstance(program, str):
        prog = parse_program(program)
    elif isinstance(program, Program):
        prog = program
    else:
        from .aten import parse_graph      # imports torch
        prog = parse_graph(program)
    # one costing pass (hierarchy routing included); both engines share it
    costed = cost_program(prog, hw, compute_dtype=compute_dtype)
    eng = simulate_program(prog, hw, compute_dtype=compute_dtype,
                           costed=costed)
    # the PA report below renders the timeline/critical path, so ask the
    # scheduler for full detail up front (sweeps use the fast path instead)
    sched = (schedule_program(prog, hw, compute_dtype=compute_dtype,
                              costed=costed, detail=True)
             if engine in ("schedule", "both") else None)
    node = sampled = None
    if engine == "node":
        if sampling is not None:
            sampled = sampled_schedule_node(
                prog, hw, n_cores, topology=topology,
                partition=node_partition, config=sampling,
                compute_dtype=compute_dtype, costed=costed)
        else:
            node = simulate_node(prog, hw, n_cores, topology=topology,
                                 partition=node_partition,
                                 compute_dtype=compute_dtype, costed=costed)
    rf = roofline_from_program(prog, hw, n_chips, model_flops_global,
                               compute_dtype)
    summary = {
        "flops_per_device": prog.flops,
        "bytes_per_device": prog.bytes_accessed,
        "comm_bytes_per_device": prog.comm_bytes,
        "comm_by_collective": prog.comm_by_collective(),
        "by_class": prog.by_class(),
        "n_partitions": prog.n_partitions,
    }
    return SimReport(hw=hw.name, n_chips=n_chips, roofline=rf, engine=eng,
                     program_summary=summary,
                     pa=pa_report(rf, eng, prog, title, sched=sched,
                                  engine_mode=engine, node=node),
                     schedule=sched, engine_mode=engine, program=prog,
                     node=node, sampled=sampled)
