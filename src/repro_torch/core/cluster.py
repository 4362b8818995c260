"""Multi-node cluster engine: TofuD-style links over the node engine.

A copy of ``repro.core.cluster``, held bit for bit against it: NumPy over
the port's node engine (``_node_pass_batch``).  The model zoo feeds it
registry models (``zoo.run_cluster``, shard axes from the port's
``parallel.sharding.MeshRules`` through ``zoo.mesh_rules_resolver``).
Every per-node program it builds keeps its source's ``exact_dtypes``.

The paper stops at one node; the ROADMAP's first open item scales the
same methodology to a Fugaku-shaped mesh (DESIGN.md §20).  This module
layers a :class:`~.hwspec.ClusterTopology` — per-link bandwidth, hop
latency from node-mesh coordinates, a per-node injection aggregate —
on top of the §17 batched node engine, the way the node engine layered
CMG ring + shared L2/HBM2 domains on the single-core schedule:

1. **Plan** — a :class:`ParallelPlan` factors the node count into
   data x tensor x pipeline parallelism.  Shard-axis resolution is
   delegated to the ``parallel.sharding`` MeshRules table (via a
   resolver callback, see ``zoo.mesh_rules_resolver``): a component
   whose dims don't divide the tensor axis stays replicated, exactly as
   the GSPMD-rule fallback would leave it.
2. **Program** — the per-node program is the traced step with work
   scaled to its shard (tensor fraction, layers-per-stage count scale)
   and the plan's collectives injected as REAL scheduled ops
   (``opclass="collective"`` riding the ``ici`` port with def-use
   edges), so they overlap compute under the node engine's O3 model
   instead of being summed analytically.
3. **Price** — every collective is priced by the ONE canonical model
   (``core.cost.collective_factor`` / ``collective_links`` /
   ``collective_steps``): ring bytes over the per-direction link
   bandwidth divided by the ring's mean hop distance (a flow crossing h
   hops occupies h links), plus per-step hop latency and the software
   startup.  Concurrent collective streams (tp/dp/pp) share the node's
   TNIs through the same :func:`~.node.effective_bandwidth` fixpoint
   the node engine uses for shared memory levels.
4. **Schedule** — cells that share a (tp, pp) structure across node
   counts differ only in durations, so a whole scaling sweep runs as
   ONE batch of the §17 vectorized pass (``_node_pass_batch``), each
   element carrying its own memory- AND link-contention state machine.

Estimates are in the zoo's reduced-trace units: the claim is *relative*
(which plan wins, how efficiency decays with scale), not absolute
seconds — the same altitude as the rest of the zoo (DESIGN.md §15).
``zoo.run_cluster`` drives this over registry models and
``benchmarks/cluster_scaling.py`` emits ``BENCH_cluster.json``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .compiled import PORTS, O3Knobs
from .cost import (collective_factor, collective_links, collective_steps,
                   cost_program)
from .hlo import OpStat, Program
from .hwspec import (A64FX_CORE, ClusterTopology, HardwareSpec,
                     NodeTopology)
from .node import (_eff_inv, _node_pass_batch, _update_active,
                   _work_domains, compile_node, compile_node_batch,
                   effective_bandwidth)

#: Ring collectives stream both torus directions; a permute gets no such
#: credit (``collective_links`` makes the distinction).
LINKS_PER_RING = 2


# ------------------------------------------------------------ plans & hops
@dataclass(frozen=True)
class ParallelPlan:
    """One (data, tensor, pipeline) factorization of the node count.

    Logical placement is row-major (pp, dp, tp) with tp fastest — tensor
    rings ride nearest-neighbour links, the pipeline axis gets the long
    strides — mirroring the TPU-mesh convention in ``launch.mesh``."""
    dp: int
    tp: int
    pp: int
    microbatches: int = 8

    @property
    def n_nodes(self) -> int:
        return self.dp * self.tp * self.pp

    @property
    def label(self) -> str:
        return f"dp{self.dp}xtp{self.tp}xpp{self.pp}"

    @property
    def bubble_fraction(self) -> float:
        """GPipe-style pipeline bubble: (pp-1)/m of the step exposed."""
        if self.pp <= 1:
            return 0.0
        return (self.pp - 1) / max(self.microbatches, 1)


@dataclass(frozen=True)
class ShardDecision:
    """Which tensor-parallel components actually shard at this tp (the
    MeshRules divisibility fallback decides; replicated components keep
    full compute and emit no collective)."""
    attn: bool = True
    mlp: bool = True
    experts: bool = False        # EP won the 'model' axis: all-to-all MoE

    def compute_scale(self, frac_attn: float, tp: int) -> float:
        """Per-node compute fraction under tensor parallelism: sharded
        components scale 1/tp, replicated ones don't (frac_attn is the
        attention share of per-layer work)."""
        if tp <= 1:
            return 1.0
        frac = frac_attn * float(self.attn) \
            + (1.0 - frac_attn) * float(self.mlp or self.experts)
        return frac / tp + (1.0 - frac)


def plan_shapes(max_tp: int = 16, max_pp: int = 16
                ) -> List[Tuple[int, int]]:
    """Candidate (tp, pp) structures: powers of two up to the caps.  dp
    is whatever the node count leaves over, so one structure serves a
    whole scaling sweep (same program, different durations)."""
    tps = [2 ** i for i in range(int(math.log2(max(max_tp, 1))) + 1)]
    pps = [2 ** i for i in range(int(math.log2(max(max_pp, 1))) + 1)]
    return [(t, p) for t in tps for p in pps]


def node_coords(cluster: ClusterTopology, ids: np.ndarray) -> np.ndarray:
    """Torus coordinates of node ids (row-major, last dim fastest)."""
    return np.stack(np.unravel_index(np.asarray(ids), cluster.mesh_shape),
                    axis=-1)


def torus_distance(cluster: ClusterTopology, a: np.ndarray,
                   b: np.ndarray) -> np.ndarray:
    """Manhattan hop count between node ids, with wraparound links."""
    d = np.abs(node_coords(cluster, a) - node_coords(cluster, b))
    if cluster.torus:
        d = np.minimum(d, np.asarray(cluster.mesh_shape) - d)
    return d.sum(axis=-1)


def axis_hops(cluster: ClusterTopology, plan: ParallelPlan
              ) -> Dict[str, float]:
    """Mean torus hop distance between ring neighbours, per logical
    axis, from the (pp, dp, tp) row-major placement — the "hop latency
    from node-mesh coordinates" term.  The pipeline axis is a chain, so
    its wraparound pair is excluded."""
    if plan.n_nodes != cluster.n_nodes:
        raise ValueError(f"plan {plan.label} places {plan.n_nodes} nodes "
                         f"on a {cluster.n_nodes}-node cluster")
    ids = np.arange(plan.n_nodes).reshape(plan.pp, plan.dp, plan.tp)
    out: Dict[str, float] = {}
    for name, ax, g, ring in (("tp", 2, plan.tp, True),
                              ("dp", 1, plan.dp, True),
                              ("pp", 0, plan.pp, False)):
        if g <= 1:
            out[name] = 0.0
            continue
        d = torus_distance(cluster, ids, np.roll(ids, -1, axis=ax))
        if not ring:
            sl = [slice(None)] * 3
            sl[ax] = slice(0, g - 1)
            d = d[tuple(sl)]
        out[name] = float(d.mean())
    return out


# --------------------------------------------------------- link-tier cost
def collective_time(kind: str, g: int, payload_bytes: float,
                    cluster: ClusterTopology, hops: float = 1.0,
                    n_active: float = 1.0) -> float:
    """Canonical inter-node collective time — the cluster engine's ONLY
    pricing path (the 2-node degenerate test recomputes it by hand).

    Wire term: ``collective_factor`` bytes over the effective link
    bandwidth — ``collective_links`` directions of ``link_bw``, divided
    by the ring's mean hop distance (a flow crossing h hops occupies h
    links), shared among ``n_active`` concurrent collective streams via
    the node engine's :func:`~.node.effective_bandwidth` against the
    TNI aggregate.  Latency term: ring steps x hops x hop latency +
    the software startup.  Zero moved bytes (g<=1, empty payload)
    charge latency only; a payload over zero bandwidth is ``inf`` —
    ``cost_op``'s conventions, one tier up.
    """
    moved = collective_factor(kind, g) * payload_bytes
    h = max(hops, 1.0)
    draw = collective_links(kind, LINKS_PER_RING) * cluster.link_bw / h
    agg = cluster.links_per_node * cluster.link_bw / h
    bw = float(effective_bandwidth(draw, agg, n_active))
    lat = collective_steps(kind, g) * hops * cluster.hop_latency_s \
        + cluster.collective_startup_us * 1e-6
    if moved > 0.0:
        return (moved / bw if bw > 0.0 else math.inf) + lat
    return lat


# -------------------------------------------------------- program building
@dataclass(frozen=True)
class CollectiveSite:
    """One injected collective of the per-node program.  ``axis`` names
    the logical ring it rides ('tp' | 'dp' | 'pp'); group size and hop
    distance are resolved per (plan, cluster) cell at pricing time, so
    one program structure serves a whole node-count sweep."""
    index: int                   # op index in the cluster program
    axis: str
    kind: str
    payload_bytes: float
    count: float


@dataclass(frozen=True)
class ClusterWorkload:
    """Everything the cluster engine needs to know about one traced
    model: the reduced one-step program plus the (reduced-unit) shape
    facts that size payloads.  ``zoo.cluster_workload`` builds these
    from registry configs; the quick bench builds synthetic ones."""
    name: str
    prog: Program
    repeats: int                 # full/reduced depth ratio (trace copies)
    layers: int                  # layers IN the reduced trace
    d_model: int
    seq_len: int
    batch: int                   # traced per-node batch
    param_bytes: float
    frac_attn: float = 0.4       # attention share of per-layer work
    moe_top_k: int = 0

    @property
    def act_bytes(self) -> float:
        """One residual-stream activation (f32, the traced dtype)."""
        return self.batch * self.seq_len * self.d_model * 4.0


def _scale_op(o: OpStat, s: float, count_scale: float) -> OpStat:
    """One op's shard copy: work fields scaled by ``s`` (tensor shard),
    loop count by ``count_scale`` (layers per stage).  ``dot_dims`` is
    left alone — MXU tile utilization is a per-tile property the shard
    keeps."""
    return dataclasses.replace(
        o,
        flops=o.flops * s,
        transcendentals=o.transcendentals * s,
        bytes_accessed=o.bytes_accessed * s,
        read_bytes=o.read_bytes * s,
        write_bytes=o.write_bytes * s,
        comm_bytes=o.comm_bytes * s,
        trans_by_opcode={k: v * s for k, v in o.trans_by_opcode.items()},
        vpu_by_opcode={k: v * s for k, v in o.vpu_by_opcode.items()},
        count=o.count * count_scale,
        deps=list(o.deps),
        dep_bytes=[b * s for b in o.dep_bytes],
    )


def _inject(ops: List[OpStat],
            protos: List[Tuple[float, OpStat, bool, str]]
            ) -> Tuple[List[OpStat], List[CollectiveSite]]:
    """Insert collective ops into the program at fractional positions.

    Each proto is ``(frac, op, blocking, axis)``: the op lands before
    the original op at ``int(frac * n)``, depends on its program-order
    predecessor through a zero-byte scheduling edge (no phantom
    traffic — the ``unroll_program`` convention), and when ``blocking``
    the displaced op gains a zero-byte dep on it (a consumer cannot
    proceed without the reduced/received activation).  Deps of the
    original ops are remapped to their shifted indices."""
    n = len(ops)
    by_pos: Dict[int, List[Tuple[OpStat, bool, str]]] = {}
    for frac, op, blocking, axis in protos:
        pos = min(n, max(0, int(frac * n)))
        by_pos.setdefault(pos, []).append((op, blocking, axis))
    new_ops: List[OpStat] = []
    old2new = np.empty(n, dtype=np.int64)
    extra_deps: Dict[int, List[int]] = {}
    sites: List[CollectiveSite] = []
    for i in range(n + 1):
        for op, blocking, axis in by_pos.get(i, ()):
            idx = len(new_ops)
            deps = [idx - 1] if idx > 0 else []
            new_ops.append(dataclasses.replace(
                op, deps=deps, dep_bytes=[0.0] * len(deps)))
            sites.append(CollectiveSite(
                index=idx, axis=axis, kind=op.opcode,
                payload_bytes=op.comm_bytes, count=op.count))
            if blocking and i < n:
                extra_deps.setdefault(i, []).append(idx)
        if i < n:
            old2new[i] = len(new_ops)
            new_ops.append(ops[i])
    for i in range(n):
        o = new_ops[old2new[i]]
        deps = [int(old2new[d]) for d in o.deps]
        dep_b = list(o.dep_bytes)
        for e in extra_deps.get(i, ()):
            deps.append(e)
            dep_b.append(0.0)
        new_ops[old2new[i]] = dataclasses.replace(o, deps=deps,
                                                  dep_bytes=dep_b)
    return new_ops, sites


def _coll(name: str, kind: str, payload: float, count: float) -> OpStat:
    return OpStat(name=name, opcode=kind, opclass="collective",
                  dtype="f32", comm_bytes=payload, group_size=0,
                  count=count)


def make_cluster_program(w: ClusterWorkload, tp: int, pp: int,
                         decision: Optional[ShardDecision] = None,
                         microbatches: int = 8
                         ) -> Tuple[Program, List[CollectiveSite]]:
    """The per-node program of one (tp, pp) structure + its collectives.

    Work scaling: every op's work fields shrink by the tensor-shard
    fraction; loop counts scale by ``repeats / pp`` (this node's share
    of the full depth, the ``trace_long_phase`` unit).  Injected ops,
    placed by position heuristics over the fwd (first half) / bwd
    (second half) regions of a traced train step:

    * tensor axis — per traced layer, a forward and backward all-reduce
      per sharded component (attention out-projection, FFN down-
      projection); MoE under expert parallelism emits dispatch+combine
      all-to-alls of ``top_k`` routed activations instead, fwd + bwd.
      Blocking: the next op consumes the reduced activation.
    * data axis — per-layer gradient-bucket all-reduces of this node's
      parameter shard, hanging off the backward region, non-blocking
      (they overlap the remaining backward and gate only the makespan).
    * pipeline axis — one forward and one backward boundary permute,
      ``microbatches`` sends of the per-microbatch activation, blocking.
      The (pp-1)/m bubble is applied analytically by the scheduler
      (:class:`ParallelPlan.bubble_fraction`).

    dp is NOT needed here: group sizes and hop distances resolve at
    pricing time, so this one structure serves every node count with
    ``n % (tp * pp) == 0`` — that is what lets a whole scaling curve run
    as one batch of the §17 engine.
    """
    if pp > max(w.repeats, 1):
        raise ValueError(f"pp={pp} exceeds the {w.repeats} trace copies "
                         f"of {w.name} (a stage needs >= 1)")
    decision = decision or ShardDecision()
    s_tp = decision.compute_scale(w.frac_attn, tp)
    cs = w.repeats / pp
    ops = [_scale_op(o, s_tp, cs) for o in w.prog.ops]
    L = max(w.layers, 1)
    act = w.act_bytes
    protos: List[Tuple[float, OpStat, bool, str]] = []
    if tp > 1:
        comps = []
        if decision.attn:
            comps.append(("attn", "all-reduce", act))
        if decision.experts and w.moe_top_k > 0:
            comps.append(("moe_dispatch", "all-to-all",
                          act * w.moe_top_k))
            comps.append(("moe_combine", "all-to-all",
                          act * w.moe_top_k))
        elif decision.mlp:
            comps.append(("mlp", "all-reduce", act))
        for li in range(L):
            for ci, (nm, kind, payload) in enumerate(comps):
                off = (li + (ci + 1.0) / (len(comps) + 1)) / L
                protos.append((0.05 + 0.40 * off,
                               _coll(f"tp_{nm}_fwd_l{li}", kind,
                                     payload, cs), True, "tp"))
                protos.append((0.50 + 0.40 * off,
                               _coll(f"tp_{nm}_bwd_l{li}", kind,
                                     payload, cs), True, "tp"))
    # data-parallel grad sync: this node's parameter bytes (tensor shard
    # of the sharded fraction, 1/pp of the depth), per-layer buckets
    grad_bytes = w.param_bytes * decision.compute_scale(
        w.frac_attn, tp) / pp
    for li in range(L):
        protos.append((0.55 + 0.40 * (li + 0.5) / L,
                       _coll(f"dp_grads_l{li}", "all-reduce",
                             grad_bytes / L, 1.0), False, "dp"))
    if pp > 1:
        m = max(microbatches, 1)
        protos.append((0.46, _coll("pp_fwd", "collective-permute",
                                   act / m, float(m)), True, "pp"))
        protos.append((0.92, _coll("pp_bwd", "collective-permute",
                                   act / m, float(m)), True, "pp"))
    new_ops, sites = _inject(ops, protos)
    prog = Program(ops=new_ops, entry=f"{w.prog.entry}@tp{tp}pp{pp}",
                   n_partitions=w.prog.n_partitions)
    if w.prog.exact_dtypes:
        prog.exact_dtypes = True
    return prog, sites


# ------------------------------------------------------------- scheduling
@dataclass
class ClusterResult:
    """One (workload, node count, plan) estimate."""
    workload: str
    n_nodes: int
    plan: ParallelPlan
    cluster: str                     # interconnect name (e.g. tofu_d_64)
    mesh_shape: Tuple[int, ...]
    t_step_s: float                  # makespan incl. pipeline bubble
    t_sched_s: float                 # scheduled makespan (no bubble)
    t_floor_s: float                 # compute-only floor (collectives free)
    parallel_efficiency: float       # t_floor / t_step
    tokens_per_s: float              # dp-weak-scaled global throughput
    ici_n_active: float              # converged concurrent-stream estimate
    iterations: int
    hops: Dict[str, float] = field(default_factory=dict)
    comm_s_by_kind: Dict[str, float] = field(default_factory=dict)
    decision: Optional[ShardDecision] = None


def _price_sites(sites: Sequence[CollectiveSite], plan: ParallelPlan,
                 cluster: ClusterTopology, hops: Dict[str, float],
                 n_active: float) -> np.ndarray:
    """[K] per-instance collective times under the current stream count."""
    g_of = {"tp": plan.tp, "dp": plan.dp, "pp": 2 if plan.pp > 1 else 1}
    return np.array([
        collective_time(s.kind, g_of[s.axis], s.payload_bytes, cluster,
                        hops=hops[s.axis], n_active=n_active)
        for s in sites])


def _stream_cap(sites: Sequence[CollectiveSite],
                plan: ParallelPlan) -> float:
    """Concurrent-collective cap: one stream per logical axis that
    actually moves bytes (the fixpoint's ``active_per_dom`` analogue)."""
    g_of = {"tp": plan.tp, "dp": plan.dp, "pp": 2 if plan.pp > 1 else 1}
    axes = {s.axis for s in sites
            if g_of[s.axis] > 1 and s.payload_bytes > 0.0}
    return float(max(len(axes), 1))


def schedule_cluster(prog: Program, sites: Sequence[CollectiveSite],
                     cells: Sequence[Tuple[ParallelPlan,
                                           ClusterTopology]],
                     hw: HardwareSpec = A64FX_CORE,
                     n_cores: int = 1,
                     topology: Optional[NodeTopology] = None,
                     compute_dtype: str = "f32",
                     knobs: Optional[O3Knobs] = None,
                     max_iters: int = 8, tol: float = 1e-2) -> List[dict]:
    """Schedule one cluster program for every (plan, cluster) cell, as
    ONE batch of the §17 vectorized pass, plus a shared compute-only
    floor element (collectives zeroed).

    Each element runs the node engine's memory-contention state machine
    (same damping/stop rules as ``schedule_node``) AND a link-tier
    fixpoint: collective durations are re-priced each round under
    ``n_active = clamp(ici_busy / makespan, 1, streams)`` — the
    :func:`~.node.effective_bandwidth` sharing rule applied to the
    TofuD injection aggregate.  Returns one dict per cell:
    ``t_sched/t_floor/ici_n_active/iterations/t_ici`` (converged
    per-site times).
    """
    topo = topology or hw.topology or NodeTopology.degenerate(n_cores)
    costed = cost_program(prog, hw, compute_dtype=compute_dtype)
    nc = compile_node(prog, hw, compute_dtype=compute_dtype,
                      costed=costed)
    nb = compile_node_batch(nc, hw, n_cores, topo, "shard")
    base_t_mem = np.array([ot.t_mem if ot is not None else 0.0
                           for ot in costed])
    coll_idx = np.array([s.index for s in sites], dtype=np.int64)
    M = len(cells) + 1                       # + the shared floor element
    kn = knobs or O3Knobs.single(hw)
    if kn.batch != 1:
        raise ValueError("schedule_cluster batches over cells; pass a "
                         "single knob combo (O3Knobs.single)")
    window = np.repeat(kn.window, M)
    width = np.repeat(kn.width, M, axis=0)
    depth = np.repeat(kn.depth, M, axis=0)
    ici_port = PORTS.index("ici")
    cores = np.arange(n_cores, dtype=np.int64)
    scale = 1.0 / n_cores
    has_caps = any(nm in topo.shared_read_bw or nm in topo.shared_write_bw
                   for nm in nc.level_names)
    mem_contended = has_caps and n_cores > 1

    # per-element state
    hops_l: List[Dict[str, float]] = []
    caps = np.ones(M)
    t_ici_el = [nc.t_ici.copy() for _ in range(M)]
    for m, (plan, cluster) in enumerate(cells):
        h = axis_hops(cluster, plan)
        hops_l.append(h)
        caps[m] = _stream_cap(sites, plan)
        # a TofuD node carries several TNIs: one in-flight collective per
        # active logical axis can drive the wire concurrently — raise the
        # ici issue width/depth to that axis count so the schedule can
        # overlap them, and let the n_active fixpoint below re-share the
        # injection bandwidth among whatever actually overlaps
        k = max(int(caps[m]), 1)
        width[m, ici_port] = max(width[m, ici_port], k)
        depth[m, ici_port] = max(depth[m, ici_port], k)
        if len(coll_idx):
            t_ici_el[m][coll_idx] = _price_sites(sites, plan, cluster,
                                                 h, 1.0)
    floor_m = M - 1
    if len(coll_idx):
        t_ici_el[floor_m][coll_idx] = 0.0
    ici_active = np.ones(M)
    mem_state = []
    for m in range(M):
        n_active, active_per_dom = _work_domains(
            nc, n_cores, True, nb.sched_core_of, cores)
        mem_state.append({"n_active": n_active,
                          "active_per_dom": active_per_dom})
    ici_contended = (caps > 1.0) & (np.arange(M) != floor_m)
    contended = np.full(M, mem_contended) | ici_contended

    t_est = np.zeros(M)
    iters = np.zeros(M, dtype=np.int64)
    done = np.zeros(M, dtype=bool)
    final = ~contended
    stale = np.ones(M, dtype=bool)
    durs_cols = np.empty((nc.n, M))

    def _durs(m: int) -> np.ndarray:
        st = mem_state[m]
        uncontended = all(float(a.max(initial=1.0)) <= 1.0
                          for a in st["n_active"])
        t_ici = t_ici_el[m]
        if uncontended and scale == 1.0:
            per = np.maximum(np.maximum(nc.t_comp, base_t_mem), t_ici)
        else:
            inv_r, inv_w = _eff_inv(nc, topo, cores, st["n_active"])
            t_mem = ((nc.rd * inv_r[0]).sum(axis=1)
                     + (nc.wr * inv_w[0]).sum(axis=1)) * scale + nc.lat
            per = np.maximum(np.maximum(nc.t_comp * scale, t_mem), t_ici)
        durs = (per + nc.startup) * nc.count
        durs[~nc.costed_mask] = 0.0
        if m == floor_m and len(coll_idx):
            durs[coll_idx] = 0.0            # compute-only floor
        return durs

    while not done.all():
        active = ~done
        for m in np.nonzero(active & stale)[0]:
            durs_cols[:, m] = _durs(m)
            stale[m] = False
        idx = np.nonzero(active)[0]
        t_est[idx] = _node_pass_batch(nb, durs_cols[:, idx], window[idx],
                                      width[idx], depth[idx])
        iters[idx] += 1
        done |= active & final
        for m in np.nonzero(active & ~final)[0]:
            damp = 0.5 if iters[m] > 1 else 1.0
            delta = 0.0
            if mem_contended:
                st = mem_state[m]
                st["n_active"], delta = _update_active(
                    nc, topo, cores, st["n_active"], nb.sched_core_of,
                    True, scale, n_cores, float(t_est[m]),
                    st["active_per_dom"], damp)
            if ici_contended[m] and len(coll_idx):
                busy = float((t_ici_el[m][coll_idx]
                              * nc.count[coll_idx]).sum())
                target = min(max(busy / max(float(t_est[m]), 1e-30),
                                 1.0), caps[m])
                nxt = damp * target + (1.0 - damp) * ici_active[m]
                delta = max(delta, abs(nxt - ici_active[m]))
                ici_active[m] = nxt
                plan, cluster = cells[m]
                t_ici_el[m][coll_idx] = _price_sites(
                    sites, plan, cluster, hops_l[m], float(nxt))
            if delta == 0.0:
                done[m] = True
            else:
                stale[m] = True
                final[m] = delta < tol or iters[m] >= max_iters

    t_floor = float(t_est[floor_m])
    out = []
    for m, (plan, cluster) in enumerate(cells):
        out.append({
            "plan": plan, "cluster": cluster, "hops": hops_l[m],
            "t_sched": float(t_est[m]), "t_floor": t_floor,
            "ici_n_active": float(ici_active[m]),
            "iterations": int(iters[m]),
            "t_ici": (t_ici_el[m][coll_idx].copy()
                      if len(coll_idx) else np.zeros(0)),
        })
    return out


def default_resolver(w: ClusterWorkload
                     ) -> Callable[[int], ShardDecision]:
    """Shard-everything resolver for synthetic workloads; real models go
    through ``zoo.mesh_rules_resolver`` (the MeshRules table + its
    divisibility fallback)."""
    def resolve(tp: int) -> ShardDecision:
        return ShardDecision(attn=True, mlp=True, experts=False)
    return resolve


def cluster_sweep(w: ClusterWorkload,
                  node_counts: Sequence[int],
                  hw: HardwareSpec = A64FX_CORE,
                  n_cores: int = 48,
                  topology: Optional[NodeTopology] = None,
                  compute_dtype: str = "f32",
                  resolver: Optional[Callable[[int],
                                              ShardDecision]] = None,
                  microbatches: int = 8,
                  max_tp: int = 16, max_pp: int = 16,
                  cluster_factory: Callable[[int], ClusterTopology]
                  = ClusterTopology.tofu_d,
                  max_iters: int = 8, tol: float = 1e-2,
                  progress: Optional[Callable[[str], None]] = None
                  ) -> List[ClusterResult]:
    """Sweep one workload over node counts x parallel plans.

    Plans are grouped by (tp, pp) structure: each group compiles ONE
    per-node program and schedules every node count (plus the shared
    compute-only floor) as one batch.  Returns every feasible cell; the
    report layer picks winners and ranks."""
    resolver = resolver or default_resolver(w)
    results: List[ClusterResult] = []
    for tp, pp in plan_shapes(max_tp, max_pp):
        if pp > max(w.repeats, 1):
            continue
        cells = []
        for n in node_counts:
            if n % (tp * pp) == 0 and n // (tp * pp) >= 1:
                plan = ParallelPlan(dp=n // (tp * pp), tp=tp, pp=pp,
                                    microbatches=microbatches)
                cells.append((plan, cluster_factory(n)))
        if not cells:
            continue
        decision = resolver(tp)
        prog, sites = make_cluster_program(w, tp, pp, decision,
                                           microbatches)
        if progress is not None:
            progress(f"{w.name} tp{tp}xpp{pp}: {len(cells)} node counts, "
                     f"{len(sites)} collectives, {len(prog.ops)} ops")
        rows = schedule_cluster(prog, sites, cells, hw, n_cores,
                                topology, compute_dtype,
                                max_iters=max_iters, tol=tol)
        for row in rows:
            plan = row["plan"]
            bubble = plan.bubble_fraction
            t_step = row["t_sched"] * (1.0 + bubble)
            by_kind: Dict[str, float] = {}
            for s, t in zip(sites, row["t_ici"]):
                by_kind[s.kind] = by_kind.get(s.kind, 0.0) \
                    + float(t) * s.count
            results.append(ClusterResult(
                workload=w.name, n_nodes=plan.n_nodes, plan=plan,
                cluster=row["cluster"].name,
                mesh_shape=tuple(row["cluster"].mesh_shape),
                t_step_s=t_step, t_sched_s=row["t_sched"],
                t_floor_s=row["t_floor"],
                parallel_efficiency=row["t_floor"] / max(t_step, 1e-30),
                tokens_per_s=plan.dp * w.batch * w.seq_len
                / max(t_step, 1e-30),
                ici_n_active=row["ici_n_active"],
                iterations=row["iterations"], hops=row["hops"],
                comm_s_by_kind=by_kind, decision=decision))
    return results
