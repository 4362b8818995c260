"""Unified per-op cost pipeline — one costing pass, two engines.

A copy of ``repro.core.cost`` (no JAX; the port's tests hold it bit for bit
against the reference).

Extracted from ``core.engine`` so that the flat occupancy engine, the
dependency-aware schedule engine, calibration, and the PA report all
consume the SAME costed op list (``cost_program``) instead of re-running
the cost model per engine:

* port assignment (MXU / VPU / DMA-mem / ICI) and compute time from the
  dtype-dependent peak FLOP/s tables,
* memory time from the multi-level hierarchy router (``core.memory``):
  per-op reads and writes are split and charged at the level the
  reuse-distance/working-set model says the data lives at,
* collective time from ring-algorithm factors over ``group_size``.

``cost_op`` stays available for costing a single op out of program
context (traffic falls back to the working-set rule).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .hlo import OpStat, Program
from .hwspec import HardwareSpec, SpecGrid
from .memory import (MemTraffic, route_program, route_program_batch,
                     route_standalone)


@dataclass
class OpTime:
    """Per-op cost decomposition: compute/memory/ICI times + routed traffic
    (the unified cost pipeline's unit, shared by all engines; DESIGN.md §3).
    """
    op: OpStat
    t_compute: float
    t_mem: float
    t_ici: float
    port: str
    useful_flops: float = 0.0     # matmul lane accounting (MXU utilization)
    padded_flops: float = 0.0
    traffic: Optional[MemTraffic] = None   # per-level routed bytes/times

    @property
    def t_op(self) -> float:
        return max(self.t_compute, self.t_mem, self.t_ici)


# ring-algorithm bandwidth factors: time = factor(g) * payload / bw
def collective_factor(kind: str, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "all-gather":
        return float(g - 1)          # payload = shard bytes
    if kind == "reduce-scatter":
        return (g - 1) / g           # payload = full buffer
    if kind == "all-to-all":
        return (g - 1) / g
    if kind == "collective-permute":
        return 1.0
    return 1.0


def collective_links(kind: str, links: int) -> int:
    """Links a collective can drive concurrently: ring algorithms stream
    both ring directions (``links``, conventionally 2), but a
    collective-permute is ONE unidirectional send and gets no multi-link
    credit.  The single place this distinction lives — ``cost_op``,
    ``cost_program_batch``, the cluster engine and
    ``parallel.collectives.CollectiveCost`` all divide by it."""
    return 1 if kind == "collective-permute" else links


def collective_steps(kind: str, g: int) -> int:
    """Serial ring steps of a collective (the latency multiplier): an
    all-reduce is reduce-scatter + all-gather (2(g-1) steps), the
    single-phase collectives take g-1, a permute is one hop."""
    if g <= 1:
        return 0
    if kind == "all-reduce":
        return 2 * (g - 1)
    if kind == "collective-permute":
        return 1
    return g - 1


def cost_op(o: OpStat, hw: HardwareSpec, ici_bw: float,
            compute_dtype: Optional[str] = None,
            traffic: Optional[MemTraffic] = None,
            links_per_collective: int = 2) -> Optional[OpTime]:
    """Per-op port assignment + per-instance times.  ``traffic`` is the
    hierarchy-routed memory traffic from ``cost_program``; when absent the
    op is routed standalone (working-set rule only).  Returns None for ops
    the cost model does not charge."""
    denorm = compute_dtype in ("bf16", "f16")

    def eff_dtype() -> str:
        if denorm and o.dtype == "f32":
            return compute_dtype
        return o.dtype

    def trans_time() -> float:
        """Per-opcode latency table (paper's OpClass extension)."""
        if not o.trans_by_opcode:
            return o.transcendentals * hw.transcendental_factor
        return sum(v * hw.opcode_factor.get(k, hw.transcendental_factor)
                   for k, v in o.trans_by_opcode.items())

    def vpu_extra() -> float:
        """Extra flop-equivalents for non-transcendental opcodes with a
        per-opcode latency entry (minimum/round/convert/...): each element
        already contributes 1 flop to ``o.flops``; a factor f adds the
        remaining f-1.  Opcodes without an entry cost exactly 1 flop, so
        an empty table reproduces the old times bit-for-bit."""
        extra = 0.0
        for k, v in o.vpu_by_opcode.items():
            f = hw.opcode_factor.get(k)
            if f is not None:
                extra += v * (f - 1.0)
        return extra

    if traffic is None and o.opclass != "collective":
        traffic = route_standalone(o, hw.memory_hierarchy(), compute_dtype,
                                   warm_caches=hw.warm_caches)

    t_c = t_m = t_i = 0.0
    useful = padded_f = 0.0
    port = "vpu"
    if o.opclass == "matmul":
        port, util = _matmul_port_util(o, hw)
        padded = o.flops / max(util, 1e-9)
        useful = o.flops * o.count
        padded_f = padded * o.count
        peak = (hw.matmul_flops(eff_dtype()) if port == "mxu"
                else hw.vector_flops(eff_dtype()))
        t_c = padded / peak
        t_m = traffic.t_mem
    elif o.opclass in ("elementwise", "reduce"):
        base = o.flops - o.transcendentals
        t_c = (base + vpu_extra() + trans_time()) / hw.vector_flops(eff_dtype())
        t_m = traffic.t_mem
    elif o.opclass == "transcendental":
        t_c = trans_time() / hw.vector_flops(eff_dtype())
        t_m = traffic.t_mem
    elif o.opclass == "data":
        t_m = traffic.t_mem
        port = "mem"
    elif o.opclass == "collective":
        f = collective_factor(o.opcode, o.group_size)
        payload = (0.5 * o.comm_bytes
                   if denorm and o.dtype == "f32" else o.comm_bytes)
        # zero moved bytes (g<=1 collectives, empty payloads) must charge
        # startup only — on extreme specs with ici_bw == 0 the old
        # unconditional division made this 0/0 (raise/NaN) instead of the
        # finite startup time (the DSE spec-fuzz edge case).  A real
        # payload over a zero-bandwidth link is cleanly infeasible: inf,
        # never a ZeroDivisionError.
        moved = f * payload
        links = collective_links(o.opcode, links_per_collective)
        bw = ici_bw if links == links_per_collective \
            else links * hw.ici_bw_per_link
        if moved > 0.0:
            t_i = (moved / bw if bw > 0.0 else math.inf) \
                + hw.collective_startup_us * 1e-6
        else:
            t_i = hw.collective_startup_us * 1e-6
        port = "ici"
        traffic = None
    else:
        return None

    # OpClass throughput overrides (the paper's operand-type table)
    t_c *= hw.opclass_throughput.get(o.opclass, 1.0)
    return OpTime(o, t_c, t_m, t_i, port,
                  useful_flops=useful, padded_flops=padded_f,
                  traffic=traffic)


def cost_program(prog: Program, hw: HardwareSpec,
                 links_per_collective: int = 2,
                 compute_dtype: Optional[str] = None
                 ) -> List[Optional[OpTime]]:
    """Cost every op once, with hierarchy routing done in program context
    (reuse distances over the def-use edges).  Both engines consume this
    list; ``simulate(engine="both")`` computes it exactly once."""
    ici_bw = links_per_collective * hw.ici_bw_per_link
    traffic = route_program(prog, hw.memory_hierarchy(), compute_dtype,
                            warm_caches=hw.warm_caches)
    return [cost_op(o, hw, ici_bw, compute_dtype, traffic=tr,
                    links_per_collective=links_per_collective)
            for o, tr in zip(prog.ops, traffic)]


# ------------------------------------------------- spec-batched costing
@dataclass
class BatchCosted:
    """Spec-batched cost decomposition over a :class:`~.hwspec.SpecGrid`
    (DESIGN.md §19): ``[n_ops, S]`` time components and ``[n_ops, L, S]``
    routed bytes.

    Structure (port assignment, which ops are charged, loop counts) is
    spec-independent by the grid's uniformity contract, so it is stored
    once; column ``s`` of every array is bit-identical to the per-spec
    scalar pipeline (``cost_program`` under ``grid.specs[s]``, pinned by
    the differential suite).  Collective and uncharged rows carry zero
    memory traffic/latency, matching the scalar ``traffic=None`` rule.
    """
    grid: SpecGrid
    level_names: Tuple[str, ...]
    port: List[Optional[str]]    # [n]; None = uncharged by the cost model
    t_compute: np.ndarray        # [n, S]
    t_mem: np.ndarray            # [n, S]
    t_ici: np.ndarray            # [n, S]
    latency: np.ndarray          # [n, S] hierarchy access latency share
    rd: np.ndarray               # [n, L, S] routed read bytes (instance)
    wr: np.ndarray               # [n, L, S]
    count: np.ndarray            # [n] loop-trip counts (1.0 if uncharged)

    @property
    def n(self) -> int:
        return len(self.port)

    def t_op(self) -> np.ndarray:
        """[n, S] per-instance op time (max over components, the scalar
        ``OpTime.t_op`` order)."""
        return np.maximum(np.maximum(self.t_compute, self.t_mem),
                          self.t_ici)


def _matmul_port_util(o: OpStat, hw) -> Tuple[str, float]:
    """Port + utilization of one matmul op — shared between the scalar
    and batched pipelines (``hw`` needs only ``mxu_tile`` and
    ``min_matmul_dim_for_mxu``, uniform across a grid)."""
    port = "mxu"
    util = 1.0
    if o.dot_dims:
        m, n, k = o.dot_dims
        if min(m, n, k) < hw.min_matmul_dim_for_mxu:
            # tiny contraction/row dims: XLA emits a VPU multiply-
            # reduce, NOT an MXU matmul — no 128-tile quantization
            # (8-lane sublane padding only).
            port = "vpu"
            util = m * n * k / (max(m, 8 * math.ceil(m / 8), 1)
                                * n * k) if m else 1.0
        else:
            tm, tk, tn = hw.mxu_tile
            pm = math.ceil(m / tm) * tm
            pk = math.ceil(k / tk) * tk
            pn = math.ceil(n / tn) * tn
            util = (m * n * k) / max(pm * pn * pk, 1)
    return port, util


def cost_program_batch(prog: Program, grid: SpecGrid,
                       links_per_collective: int = 2,
                       compute_dtype: Optional[str] = None) -> BatchCosted:
    """Cost every op against every spec of the grid in one pass.

    Routing runs spec-batched (``route_program_batch``: def-use edges,
    opclasses and effective bytes computed once); per-op rate lookups
    (flops tables, per-opcode latency factors, transfer rates) become
    ``[S]`` vectors.  Bit-identity with the per-spec scalar loop is the
    contract: every accumulation replays ``cost_op``'s float ops in the
    same order per element — the per-opcode tables are folded in dict
    order, ``(base + vpu_extra) + trans`` keeps its association, and the
    collective guard matches the fixed scalar path.
    """
    S = grid.S
    n = len(prog.ops)
    L = len(grid.level_names)
    denorm = compute_dtype in ("bf16", "f16")
    tb = route_program_batch(prog, grid.hierarchies(), compute_dtype,
                             warm_caches=grid.warm_caches)
    t_mem_all = tb.t_mem                       # [n, S]
    ici_bw = links_per_collective * grid.ici_bw_per_link
    coll_start = grid.collective_startup_us * 1e-6

    port: List[Optional[str]] = [None] * n
    t_comp = np.zeros((n, S))
    t_ici = np.zeros((n, S))
    count = np.ones(n)
    zeros_s = np.zeros(S)                      # read-only template

    for i, o in enumerate(prog.ops):
        eff = (compute_dtype if denorm and o.dtype == "f32" else o.dtype)

        if o.opclass == "matmul":
            p, util = _matmul_port_util(o, grid)
            padded = o.flops / max(util, 1e-9)
            peak = (grid.matmul_flops(eff) if p == "mxu"
                    else grid.vector_flops(eff))
            tc = padded / peak
        elif o.opclass in ("elementwise", "reduce", "transcendental"):
            p = "vpu"
            if not o.trans_by_opcode:
                tt = o.transcendentals * grid.transcendental
            else:
                tt = zeros_s
                for k, v in o.trans_by_opcode.items():
                    tt = tt + v * grid.trans_factor(k)
            if o.opclass == "transcendental":
                tc = tt / grid.vector_flops(eff)
            else:
                base = o.flops - o.transcendentals
                extra = zeros_s
                for k, v in o.vpu_by_opcode.items():
                    extra = extra + v * grid.vpu_extra_factor(k)
                tc = (base + extra + tt) / grid.vector_flops(eff)
        elif o.opclass == "data":
            p = "mem"
            tc = zeros_s
        elif o.opclass == "collective":
            p = "ici"
            f = collective_factor(o.opcode, o.group_size)
            payload = (0.5 * o.comm_bytes
                       if denorm and o.dtype == "f32" else o.comm_bytes)
            moved = f * payload
            links = collective_links(o.opcode, links_per_collective)
            bw = ici_bw if links == links_per_collective \
                else links * grid.ici_bw_per_link
            if moved > 0.0:
                with np.errstate(divide="ignore"):
                    t_ici[i] = np.where(bw > 0.0, moved / bw,
                                        np.inf) + coll_start
            else:
                t_ici[i] = coll_start
            tc = zeros_s
        else:
            continue
        port[i] = p
        count[i] = o.count
        t_comp[i] = tc * grid.opclass_throughput_arr(o.opclass)

    # memory traffic applies only to charged, non-collective ops (the
    # scalar path drops ``traffic`` for collectives and never costs the
    # rest); zero their rows so downstream per-level tallies agree
    keep = np.array([p is not None and p != "ici" for p in port],
                    dtype=bool)
    t_mem = np.where(keep[:, None], t_mem_all, 0.0)
    latency = np.where(keep[:, None], tb.latency, 0.0)
    rd = tb.read_by_level
    wr = tb.write_by_level
    rd[~keep] = 0.0
    wr[~keep] = 0.0

    return BatchCosted(grid=grid, level_names=grid.level_names, port=port,
                       t_compute=t_comp, t_mem=t_mem, t_ici=t_ici,
                       latency=latency, rd=rd, wr=wr, count=count)
