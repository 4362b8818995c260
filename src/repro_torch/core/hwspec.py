"""Hardware parameter files — the gem5-parameter analogue.

The RIKEN simulator's accuracy came from *detailed parameter tuning*: per-
OpClass latencies (extended to be operand-dtype-dependent), asymmetric bus
widths, HBM2 timing, load/store port rules.  ``HardwareSpec`` carries the
same kinds of knobs for our targets:

* ``TPU_V5E``  — the deployment target (roofline constants per assignment:
  197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI).
* ``A64FX_CMG`` — the paper's own target, parameterized from the paper text
  (used by the paper-faithful kernel-suite benchmark).
* ``CPU_HOST`` — the machine we can actually measure (our "test chip");
  its parameters are *fitted* by ``core.calibrate`` exactly the way RIKEN
  tuned gem5 against Fujitsu's numbers.
* ``H100`` — the port's test chip (NVIDIA's published rates), fitted on the
  card by ``core.calibrate.fit_h100``.  The rest of this module is a copy
  of ``repro.core.hwspec``.

Throughputs are per *modeled unit* — per chip for the TPU specs (meshes
scale them by chip count), per **core** for ``A64FX_CORE``/``CPU_HOST``.
A per-core spec plus a :class:`NodeTopology` (CMG counts, per-level
aggregate bandwidths shared by ``MemLevel.shared_by`` cores, inter-CMG
ring) is what the multi-core node engine (``core.node``, DESIGN.md §14)
scales up to one full processor: per-core paths stay the single-core draw
limits, the topology caps what the sharing domain can deliver in total.

Memory is a real multi-level hierarchy (``core.memory``, DESIGN.md §12):
``memory_hierarchy()`` returns the ordered ``MemLevel`` list, innermost
first.  The scalar knobs (``vmem_bytes``/``vmem_bw`` for the innermost
level, ``hbm_read_bw``/``hbm_write_bw``/``hbm_bytes`` for the outermost)
remain the calibration/tuning surface; ``mem_levels`` adds intermediate
levels (the A64FX L2) and asymmetric inner paths.  ``with_`` keeps the two
representations consistent: replacing a boundary scalar rewrites the
matching boundary level.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .memory import MemLevel

# scalar knobs that describe the hierarchy's boundary levels; with_() maps
# them onto mem_levels so that e.g. with_(hbm_write_bw=x) always matters
_INNER_SCALARS = ("vmem_bytes", "vmem_bw")
_OUTER_SCALARS = ("hbm_bytes", "hbm_read_bw", "hbm_write_bw")


@dataclass(frozen=True)
class NodeTopology:
    """Node-level structure for the multi-core engine (``core.node``).

    Cores are numbered compactly: core ``c`` lives on CMG
    ``c // cores_per_cmg`` (OpenMP "close" pinning), so a 12-core run
    fills one CMG — the paper's Figs 4/5 thread-scaling setup.  For each
    memory level whose ``MemLevel.shared_by > 1``, the sharing domain is
    the block of ``shared_by`` consecutive cores, and the aggregate
    bandwidth the domain can draw is capped by ``shared_read_bw`` /
    ``shared_write_bw`` (keyed by level name).  Levels with no entry are
    contention-free: each core keeps its full per-core path.
    """
    name: str
    n_cmgs: int
    cores_per_cmg: int
    # aggregate bytes/s one sharing domain can draw at a level; absent
    # level names mean "no shared cap" (private or never saturated)
    shared_read_bw: Dict[str, float] = field(default_factory=dict)
    shared_write_bw: Dict[str, float] = field(default_factory=dict)
    # inter-CMG ring: a def-use edge crossing CMGs delays the consumer's
    # readiness by ring_latency_s (coherence hop; bytes are not re-charged
    # — the producer already paid the store path)
    ring_latency_s: float = 0.0
    ring_bw: float = 0.0

    @property
    def n_cores(self) -> int:
        return self.n_cmgs * self.cores_per_cmg

    def cmg_of(self, core: int) -> int:
        return core // self.cores_per_cmg

    @classmethod
    def degenerate(cls, n_cores: int) -> "NodeTopology":
        """No shared caps, no ring: n identical fully-private cores.  The
        node engine under this topology with one core is bit-identical to
        the single-core schedule (the differential tests pin this)."""
        return cls(name=f"degenerate_{n_cores}", n_cmgs=1,
                   cores_per_cmg=n_cores)


@dataclass(frozen=True)
class ClusterTopology:
    """Inter-node interconnect for the multi-node cluster engine
    (``core.cluster``, DESIGN.md §20) — the TofuD-style tier above
    :class:`NodeTopology`, shaped like a ``MemLevel`` with ``shared_by``
    semantics: per-link bandwidth, per-hop latency from node-mesh
    coordinates, and a per-node injection aggregate
    (``links_per_node * link_bw``) that concurrently-active collective
    streams share through the same ``effective_bandwidth`` fixpoint the
    node engine uses for L2/HBM2 domains.

    Nodes sit on a ``mesh_shape`` torus (TofuD is a 6-D torus; three
    logical dimensions capture its routing distances at this altitude).
    Node ids map to coordinates row-major (last dimension fastest); a hop
    between adjacent coordinates costs ``hop_latency_s`` and every hop a
    flow crosses consumes one link's worth of capacity, so a g-member
    ring whose neighbours sit h hops apart sees ``link_bw / h`` per
    direction.
    """
    name: str
    mesh_shape: Tuple[int, ...]
    link_bw: float                       # bytes/s per link per direction
    links_per_node: int = 6              # TofuD: 6 TNIs (RDMA engines)
    hop_latency_s: float = 100e-9        # per switch-to-switch hop
    collective_startup_us: float = 0.54  # software put latency per step 0
    torus: bool = True                   # wraparound links on every dim

    @property
    def n_nodes(self) -> int:
        n = 1
        for d in self.mesh_shape:
            n *= d
        return n

    @classmethod
    def tofu_d(cls, n_nodes: int) -> "ClusterTopology":
        """A near-cubic TofuD-flavoured torus over ``n_nodes`` nodes:
        6.8 GB/s per link per direction, six TNIs per node (40.8 GB/s
        injection), ~0.49-0.54 us one-hop put latency split into a
        per-hop wire term and a software startup term.  The shape is the
        most balanced 3-factor decomposition of ``n_nodes`` (ties broken
        toward the larger trailing dim, where ring neighbours are one
        hop apart)."""
        best = None
        for a in range(1, int(round(n_nodes ** (1 / 3))) + 1):
            if n_nodes % a:
                continue
            rest = n_nodes // a
            for b in range(a, int(rest ** 0.5) + 1):
                if rest % b:
                    continue
                c = rest // b
                cand = (a, b, c)
                score = max(cand) / min(cand)
                if best is None or score < best[0]:
                    best = (score, cand)
        shape = best[1] if best is not None else (1, 1, n_nodes)
        return cls(name=f"tofu_d_{n_nodes}", mesh_shape=shape,
                   link_bw=6.8e9, links_per_node=6)


@dataclass(frozen=True)
class HardwareSpec:
    """One hardware parameter file (the gem5-parameter analogue,
    DESIGN.md §4): compute ports, memory hierarchy, interconnect,
    overlap model and O3 scheduling resources, per modeled unit
    (chip for TPU specs, core for A64FX_CORE/CPU_HOST).
    """
    name: str
    # ---- compute ports (paper: reservation stations / execution units)
    peak_flops: Dict[str, float]        # dtype -> FLOP/s on the matrix unit
    vpu_flops: Dict[str, float]         # dtype -> FLOP/s on the vector unit
    transcendental_factor: float        # VPU slowdown for exp/log/sin/... ops
    # ---- memory hierarchy (paper: L1/L2/HBM2 function expansion).
    # Boundary scalars: outermost level (HBM/DRAM) ...
    hbm_read_bw: float                  # bytes/s (asymmetric, like L1 ports)
    hbm_write_bw: float
    hbm_bytes: int
    # ... and innermost level (L1/VMEM):
    vmem_bytes: int
    vmem_bw: float                      # bytes/s, symmetric unless mem_levels
    # ---- interconnect
    ici_links: int
    ici_bw_per_link: float              # bytes/s each direction
    # ---- pipeline/overlap model (paper: OoO overlap of compute & memory)
    dma_overlap: float = 0.85           # fraction of mem traffic hidden under compute
    ici_overlap: float = 0.30           # fraction of collective time hidden (async)
    serialization: float = 0.10         # residual dependency serialization
    op_startup_ns: float = 2_000.0      # per-HLO-op launch/pipeline-fill cost
    collective_startup_us: float = 10.0 # per-collective latency
    # ---- O3 scheduling resources (core.schedule; the gem5 ROB / issue /
    # reservation-station analogue).  The occupancy engine ignores these.
    #   issue_width[port]: parallel pipes per port (async DMA engines, dual
    #                      VPU issue, per-direction ICI injection).
    #   inflight_window:   ROB size — op i cannot issue until op i-window
    #                      has retired (in-order retirement).
    #   queue_depth[port]: reservation-station depth — op i cannot issue
    #                      until the op `depth` earlier on its port issued.
    issue_width: Dict[str, int] = field(
        default_factory=lambda: {"mxu": 1, "vpu": 1, "mem": 2, "ici": 1})
    inflight_window: int = 64
    queue_depth: Dict[str, int] = field(
        default_factory=lambda: {"mxu": 16, "vpu": 16, "mem": 16, "ici": 8})
    # ---- OpClass overrides (paper's operand-type-dependent latency table)
    opclass_throughput: Dict[str, float] = field(default_factory=dict)
    # per-HLO-opcode slowdown factors vs plain vector ops (paper: per-OpClass
    # instruction latencies, extended per operand type). Keys like
    # 'cosine', 'exponential', 'divide'; falls back to transcendental_factor.
    opcode_factor: Dict[str, float] = field(default_factory=dict)
    # matmul efficiency depends on MXU tile alignment; dims padded to this
    mxu_tile: Tuple[int, int, int] = (128, 128, 128)   # (M, K, N) granularity
    min_matmul_dim_for_mxu: int = 8     # tiny dots fall back to VPU
    # explicit memory hierarchy, innermost first.  Empty -> the two-level
    # (vmem, hbm) hierarchy is derived from the boundary scalars above.
    # When set, the innermost/outermost levels MUST mirror the scalars
    # (with_ maintains this; see module docstring).
    mem_levels: Tuple[MemLevel, ...] = ()
    # True when the inner levels are hardware-managed caches kept warm
    # across calls (CPU, A64FX): cold reads and writes take the working-
    # set residency rule.  False for software-managed scratch (TPU VMEM):
    # cold traffic streams from the outermost level; only def-use reuse
    # is charged at inner-level bandwidth (DESIGN.md §12).
    warm_caches: bool = False
    # node structure for the multi-core engine; None = single-unit spec
    # (core.node falls back to a degenerate contention-free topology)
    topology: Optional[NodeTopology] = None

    def with_(self, **kw) -> "HardwareSpec":
        new = dataclasses.replace(self, **kw)
        if new.mem_levels and "mem_levels" not in kw \
                and any(k in kw for k in _INNER_SCALARS + _OUTER_SCALARS):
            # rewrite ONLY the level fields whose scalar was passed —
            # e.g. with_(vmem_bytes=...) must not flatten an asymmetric
            # L1 load/store pair back to the symmetric vmem_bw scalar
            lv = list(new.mem_levels)
            inner_kw = {}
            if "vmem_bytes" in kw:
                inner_kw["capacity"] = float(new.vmem_bytes)
            if "vmem_bw" in kw:
                inner_kw["read_bw"] = float(new.vmem_bw)
                inner_kw["write_bw"] = float(new.vmem_bw)
            if inner_kw:
                lv[0] = dataclasses.replace(lv[0], **inner_kw)
            outer_kw = {}
            if "hbm_bytes" in kw:
                outer_kw["capacity"] = float(new.hbm_bytes)
            if "hbm_read_bw" in kw:
                outer_kw["read_bw"] = new.hbm_read_bw
            if "hbm_write_bw" in kw:
                outer_kw["write_bw"] = new.hbm_write_bw
            if outer_kw:
                lv[-1] = dataclasses.replace(lv[-1], **outer_kw)
            new = dataclasses.replace(new, mem_levels=tuple(lv))
        return new

    def matmul_flops(self, dtype: str) -> float:
        return self.peak_flops.get(dtype, self.peak_flops.get("default", 1e12))

    def vector_flops(self, dtype: str) -> float:
        return self.vpu_flops.get(dtype, self.vpu_flops.get("default", 1e12))

    def memory_hierarchy(self) -> Tuple[MemLevel, ...]:
        """Ordered hierarchy, innermost first (L1/VMEM -> ... -> HBM).

        Memoized on the (frozen) spec: ``route_*``/``cost_program`` call
        this in hot loops and must not rebuild the tuple every time.
        ``dataclasses.replace`` (and therefore ``with_``) returns a fresh
        instance without the cache, so stale hierarchies cannot leak."""
        cached = getattr(self, "_mh_cache", None)
        if cached is not None:
            return cached
        if self.mem_levels:
            mh = self.mem_levels
        else:
            mh = (
                MemLevel("vmem", float(self.vmem_bytes),
                         float(self.vmem_bw), float(self.vmem_bw)),
                MemLevel("hbm", float(self.hbm_bytes),
                         self.hbm_read_bw, self.hbm_write_bw),
            )
        object.__setattr__(self, "_mh_cache", mh)
        return mh


class SpecGrid:
    """Structure-of-arrays over S :class:`HardwareSpec`\\ s — the spec
    batch axis of the fused DSE sweeps (DESIGN.md §19).

    A grid is *structurally uniform*: every spec shares the hierarchy
    depth and level names, ``warm_caches``, the MXU tile shape and the
    VPU-fallback threshold — everything that decides port assignment or
    program structure — while every numeric rate (flops tables, level
    capacities/bandwidths/latencies, per-opcode factors, ICI, startups,
    topology parameters) varies freely per spec.  ``cost_program_batch``
    evaluates those rates as ``[S]`` vectors per op; construction
    validates uniformity and raises ``ValueError`` otherwise.

    Grids compare by VALUE over ``(specs, topologies)`` — the compile
    caches (``compile_node_grid``) key on that, so a rebuilt equal grid
    hits and a 1-spec grid can never alias a plain single-spec entry
    (different cache, different key type).
    """

    def __init__(self, specs: Sequence[HardwareSpec],
                 topologies: Optional[Sequence[Optional[NodeTopology]]]
                 = None):
        specs = tuple(specs)
        if not specs:
            raise ValueError("empty spec grid")
        if topologies is None:
            topologies = tuple(sp.topology for sp in specs)
        else:
            topologies = tuple(topologies)
            if len(topologies) != len(specs):
                raise ValueError("topologies/specs length mismatch")
        base = specs[0]
        names = tuple(lv.name for lv in base.memory_hierarchy())
        for sp in specs:
            if tuple(lv.name for lv in sp.memory_hierarchy()) != names:
                raise ValueError(f"{sp.name}: level structure differs "
                                 f"from {base.name}")
            if sp.warm_caches != base.warm_caches:
                raise ValueError(f"{sp.name}: warm_caches differs")
            if sp.mxu_tile != base.mxu_tile:
                raise ValueError(f"{sp.name}: mxu_tile differs")
            if sp.min_matmul_dim_for_mxu != base.min_matmul_dim_for_mxu:
                raise ValueError(f"{sp.name}: min_matmul_dim_for_mxu "
                                 "differs")
        self.specs = specs
        self.topologies = topologies
        self.level_names = names
        self.warm_caches = base.warm_caches
        self.mxu_tile = base.mxu_tile
        self.min_matmul_dim_for_mxu = base.min_matmul_dim_for_mxu
        self.transcendental = np.array(
            [sp.transcendental_factor for sp in specs])
        self.ici_bw_per_link = np.array(
            [sp.ici_bw_per_link for sp in specs])
        self.collective_startup_us = np.array(
            [sp.collective_startup_us for sp in specs])
        self.op_startup_ns = np.array([sp.op_startup_ns for sp in specs])
        self._flops_cache: Dict[Tuple[str, str], np.ndarray] = {}
        self._factor_cache: Dict[Tuple[str, str], np.ndarray] = {}

    @property
    def S(self) -> int:
        return len(self.specs)

    def __eq__(self, other) -> bool:
        return (isinstance(other, SpecGrid)
                and self.specs == other.specs
                and self.topologies == other.topologies)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    __hash__ = None

    def topology_of(self, s: int) -> NodeTopology:
        """Spec ``s``'s node topology (degenerate single-core fallback,
        mirroring ``schedule_node``'s resolution)."""
        return self.topologies[s] or NodeTopology.degenerate(1)

    def hierarchies(self) -> List[Tuple[MemLevel, ...]]:
        """Per-spec ordered hierarchies (for the batched router)."""
        return [sp.memory_hierarchy() for sp in self.specs]

    def matmul_flops(self, dtype: str) -> np.ndarray:
        """[S] MXU peak FLOP/s at ``dtype`` (memoized per dtype)."""
        key = ("mxu", dtype)
        out = self._flops_cache.get(key)
        if out is None:
            out = self._flops_cache[key] = np.array(
                [sp.matmul_flops(dtype) for sp in self.specs])
        return out

    def vector_flops(self, dtype: str) -> np.ndarray:
        """[S] VPU peak FLOP/s at ``dtype`` (memoized per dtype)."""
        key = ("vpu", dtype)
        out = self._flops_cache.get(key)
        if out is None:
            out = self._flops_cache[key] = np.array(
                [sp.vector_flops(dtype) for sp in self.specs])
        return out

    def trans_factor(self, opcode: str) -> np.ndarray:
        """[S] per-opcode latency factor with each spec's
        ``transcendental_factor`` as its own fallback (the scalar
        ``trans_time`` lookup, vectorized)."""
        key = ("t", opcode)
        out = self._factor_cache.get(key)
        if out is None:
            out = self._factor_cache[key] = np.array(
                [sp.opcode_factor.get(opcode, sp.transcendental_factor)
                 for sp in self.specs])
        return out

    def vpu_extra_factor(self, opcode: str) -> np.ndarray:
        """[S] extra flop-equivalents factor ``f - 1`` for non-trans
        opcodes; specs without an entry contribute 0.0 — adding that 0.0
        is a float no-op, so per-spec table presence may differ while the
        scalar ``vpu_extra`` skip stays bit-reproduced."""
        key = ("v", opcode)
        out = self._factor_cache.get(key)
        if out is None:
            vals = [sp.opcode_factor.get(opcode) for sp in self.specs]
            out = self._factor_cache[key] = np.array(
                [0.0 if f is None else f - 1.0 for f in vals])
        return out

    def opclass_throughput_arr(self, opclass: str) -> np.ndarray:
        """[S] OpClass throughput override (default 1.0)."""
        key = ("o", opclass)
        out = self._factor_cache.get(key)
        if out is None:
            out = self._factor_cache[key] = np.array(
                [sp.opclass_throughput.get(opclass, 1.0)
                 for sp in self.specs])
        return out


TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops={"bf16": 197e12, "f32": 49.25e12, "f16": 197e12,
                "s8": 394e12, "default": 49.25e12},
    vpu_flops={"f32": 4.9e12, "bf16": 4.9e12, "default": 2.45e12},
    transcendental_factor=8.0,
    hbm_read_bw=819e9,
    hbm_write_bw=819e9,
    hbm_bytes=16 * 2**30,
    vmem_bytes=128 * 2**20,
    vmem_bw=11e12,
    # mem_levels derived: (vmem 128 MiB @ 11 TB/s, hbm 16 GiB @ 819 GB/s) —
    # v5e has no intermediate cache between VMEM and HBM
    ici_links=4,                        # 2D torus on a 16x16 pod
    ici_bw_per_link=50e9,
    dma_overlap=0.85,
    ici_overlap=0.30,
    serialization=0.08,
)

TPU_V4 = HardwareSpec(
    name="tpu_v4",
    peak_flops={"bf16": 275e12, "f32": 68.75e12, "default": 68.75e12},
    vpu_flops={"f32": 4.3e12, "default": 2.2e12},
    transcendental_factor=8.0,
    hbm_read_bw=1228e9,
    hbm_write_bw=1228e9,
    hbm_bytes=32 * 2**30,
    vmem_bytes=128 * 2**20,
    vmem_bw=14e12,
    # mem_levels derived: (vmem 128 MiB @ 14 TB/s, hbm 32 GiB @ 1.23 TB/s)
    ici_links=6,                        # 3D torus
    ici_bw_per_link=50e9,
)

# The paper's processor, one CMG, parameterized from the paper text:
# 12 compute cores, 2x512-bit SIMD FMA pipes @ 1.8 GHz (test chip),
# L1D 64 KiB (load >230 GB/s, store >115 GB/s per core), L2 8 MiB
# (>900 GB/s/CMG), HBM2 256 GB/s/CMG.
_A64FX_GHZ = 1.8e9
_A64FX_CORE_F64 = 2 * 8 * 2 * _A64FX_GHZ        # 57.6 GFLOP/s per core

# Per-opcode VPU latency factors (the paper's per-OpClass instruction
# latencies, "detailed parameter tuning"): per-element cost relative to a
# pipelined SVE FMA.  fdiv/fsqrt are unpipelined on the A64FX FLA pipe
# (~40 cycles / 2 pipes vs a 4-cycle FMA); compare-select pairs take two
# µops; frint/fcvt chains cost a couple.  Without these, every
# memory-resident kernel of a class collapses to the same t_est (the
# BENCH_kernel_suite degeneracy this table fixes).
_A64FX_OPCODE_FACTOR = {
    "divide": 20.0, "remainder": 24.0, "sqrt": 18.0, "rsqrt": 18.0,
    "cbrt": 24.0, "exponential": 6.0, "exponential-minus-one": 7.0,
    "log": 8.0, "log-plus-one": 9.0, "sine": 10.0, "cosine": 10.0,
    "tan": 16.0, "atan2": 22.0, "power": 26.0, "tanh": 10.0,
    "logistic": 9.0, "erf": 9.0, "erf-inv": 14.0,
    "maximum": 2.0, "minimum": 2.0,
    "round-nearest-even": 3.0, "round-nearest-afz": 3.0,
    "floor": 3.0, "ceil": 3.0, "sign": 2.0, "convert": 2.0,
}

A64FX_CMG = HardwareSpec(
    name="a64fx_cmg",
    peak_flops={"f64": 12 * _A64FX_CORE_F64,
                "f32": 24 * _A64FX_CORE_F64,
                "default": 12 * _A64FX_CORE_F64},
    vpu_flops={"f64": 12 * _A64FX_CORE_F64,
               "f32": 24 * _A64FX_CORE_F64,
               "default": 12 * _A64FX_CORE_F64},
    transcendental_factor=6.0,          # inlined SVE math functions
    opcode_factor=dict(_A64FX_OPCODE_FACTOR),
    hbm_read_bw=256e9,
    hbm_write_bw=256e9,
    hbm_bytes=8 * 2**30,
    vmem_bytes=12 * 64 * 2**10,         # aggregate L1D across the CMG
    vmem_bw=12 * 230e9,
    # the paper's three-level function expansion; L1 load/store asymmetry
    # per the paper text, L2 store path at the same 2:1 ratio
    mem_levels=(
        MemLevel("l1d", 12 * 64 * 2**10, 12 * 230e9, 12 * 115e9, 2.8e-9),
        MemLevel("l2", 8 * 2**20, 900e9, 450e9, 20e-9),
        MemLevel("hbm2", 8 * 2**30, 256e9, 256e9, 120e-9),
    ),
    warm_caches=True,                   # real HW-managed L1/L2
    ici_links=6,                        # TofuD
    ici_bw_per_link=6.8e9,
    dma_overlap=0.7,                    # HW prefetch (K-compatible, per paper)
    serialization=0.12,
    op_startup_ns=100.0,
)

# The full-node structure the per-core spec scales up to: 4 CMGs x 12
# cores, one 8 MiB L2 (>900 GB/s aggregate) and one HBM2 stack
# (256 GB/s) per CMG, CMGs linked by the on-chip ring bus.  The node
# engine divides each shared level's aggregate among the cores actively
# streaming through it — replacing the old hardcoded "one core gets ~1/4
# of the CMG's HBM2" approximation with a contention model.
A64FX_NODE = NodeTopology(
    name="a64fx_node", n_cmgs=4, cores_per_cmg=12,
    shared_read_bw={"l2": 900e9, "hbm2": 256e9},
    shared_write_bw={"l2": 450e9, "hbm2": 256e9},
    ring_latency_s=130e-9,              # inter-CMG coherence hop
    ring_bw=115e9,
)

# One A64FX core (Fig. 3 of the paper is single-core): private L1D with the
# paper's asymmetric load/store ports, a 1/12 share of the L2 capacity, and
# the single-core draw limits on the shared CMG paths (~1/4 of the
# 256 GB/s HBM2, store path at the L1 2:1 ratio).  ``shared_by`` marks the
# L2/HBM2 paths as CMG-shared; ``topology`` carries the aggregates the
# node engine divides among active cores.
A64FX_CORE = A64FX_CMG.with_(
    name="a64fx_core",
    peak_flops={"f64": _A64FX_CORE_F64, "f32": 2 * _A64FX_CORE_F64,
                "default": _A64FX_CORE_F64},
    vpu_flops={"f64": _A64FX_CORE_F64, "f32": 2 * _A64FX_CORE_F64,
               "default": _A64FX_CORE_F64},
    hbm_read_bw=64e9,
    hbm_write_bw=32e9,
    vmem_bytes=64 * 2**10,              # private L1D
    vmem_bw=230e9,
    # per-path bandwidths decrease monotonically outward (the §12
    # residency-monotonicity contract): the single-core L2 draw is capped
    # below the L1 ports it front-ends
    mem_levels=(
        MemLevel("l1d", 64 * 2**10, 230e9, 115e9, 2.8e-9),
        MemLevel("l2", 8 * 2**20 // 12, 200e9, 100e9, 20e-9, shared_by=12),
        MemLevel("hbm2", 8 * 2**30, 64e9, 32e9, 120e-9, shared_by=12),
    ),
    topology=A64FX_NODE,
    dma_overlap=1.0,                    # loads are pipelined under FMA issue
    op_startup_ns=50.0,
)

# Fitted by core.calibrate on the actual host; these are fallback defaults.
# Two derived levels: (vmem = LLC, hbm = DRAM); calibrate fits each level's
# bandwidth from microbenchmarks that isolate it.
CPU_HOST = HardwareSpec(
    name="cpu_host",
    peak_flops={"f64": 5e10, "f32": 1e11, "default": 5e10},
    vpu_flops={"f64": 5e10, "f32": 1e11, "default": 5e10},
    transcendental_factor=10.0,
    # fallback per-opcode latency table (libm call costs dominate on a
    # host CPU); core.calibrate re-fits the transcendental entries from
    # microbenchmarks and keeps the rest
    opcode_factor={
        "divide": 40.0, "remainder": 45.0, "sqrt": 35.0, "rsqrt": 40.0,
        "exponential": 90.0, "log": 80.0, "sine": 110.0, "cosine": 110.0,
        "tan": 180.0, "atan2": 260.0, "power": 220.0, "tanh": 100.0,
        "logistic": 100.0, "erf": 100.0,
        "maximum": 1.5, "minimum": 1.5, "round-nearest-even": 3.0,
    },
    hbm_read_bw=2e10,
    hbm_write_bw=1.5e10,
    hbm_bytes=16 * 2**30,
    vmem_bytes=32 * 2**20,              # LLC
    vmem_bw=2e11,
    warm_caches=True,                   # real HW-managed cache hierarchy
    ici_links=1,
    ici_bw_per_link=1e10,
    dma_overlap=0.5,
    serialization=0.3,
    op_startup_ns=20_000.0,             # interpreter/dispatch heavy
)

# NVIDIA H100 SXM5 80 GB, the port's test chip: the whole card is one unit
# (132 SMs behind one shared L2).  Rates from NVIDIA's "H100 Tensor Core GPU"
# data sheet (SXM column, dense, at the 700 W limit): 989 TFLOP/s bf16/f16 on
# the tensor cores, 67 TFLOP/s f64 on the FP64 tensor cores, 67 TFLOP/s f32
# on the CUDA cores (the port never uses TF32), 34 TFLOP/s f64 on the CUDA
# cores; 80 GB of HBM3 at 3.35 TB/s; 50 MB of L2; NVLink 4 at 900 GB/s, 18
# links of 25 GB/s each way.  NVIDIA publishes no L2 bandwidth, launch cost
# or per-instruction f64 costs: ``vmem_bw``, ``op_startup_ns`` and the
# opcode factors below are PLACEHOLDERS, which ``core.calibrate.fit_h100``
# replaces by measurement (the factors of its ``_FACTOR_FIT`` opcodes).
#
# Per-opcode factors: per-element cost relative to one pipelined f64 FMA
# (DFMA, 64 per clock per SM).  f64 conversions and roundings (F2F/F2I/I2F,
# FRND) issue at 16 per clock per SM (CUDA C++ Programming Guide, throughput
# table for compute capability 9.0): 4.  divide and sqrt are a MUFU
# reciprocal seed and ~8 DFMA Newton/correction steps; exp, log, sin, cos,
# atan2 and pow are libdevice polynomial evaluations with range reduction,
# guessed at ~20-50 DFMAs each: placeholders too, until fitted.
_H100_OPCODE_FACTOR = {
    "divide": 10.0, "remainder": 12.0, "sqrt": 10.0, "rsqrt": 8.0,
    "exponential": 20.0, "exponential-minus-one": 22.0, "log": 24.0,
    "log-plus-one": 26.0, "sine": 30.0, "cosine": 30.0, "tan": 40.0,
    "atan2": 45.0, "power": 50.0, "tanh": 30.0, "logistic": 24.0,
    "erf": 30.0, "erf-inv": 40.0,
    "convert": 4.0, "round-nearest-even": 4.0, "round-nearest-afz": 4.0,
    "floor": 4.0, "ceil": 4.0,
}

H100 = HardwareSpec(
    name="h100",
    peak_flops={"bf16": 989e12, "f16": 989e12, "f64": 67e12, "f32": 67e12,
                "default": 67e12},
    vpu_flops={"f64": 34e12, "f32": 67e12, "default": 34e12},
    transcendental_factor=25.0,
    opcode_factor=dict(_H100_OPCODE_FACTOR),
    hbm_read_bw=3.35e12,
    hbm_write_bw=3.35e12,
    hbm_bytes=80 * 10**9,
    vmem_bytes=50 * 2**20,              # the L2
    vmem_bw=10e12,                      # PLACEHOLDER: fitted by fit_h100
    warm_caches=True,                   # a hardware-managed L2, warm across calls
    mxu_tile=(64, 16, 8),               # wgmma's bf16 granularity (M, K, N)
    ici_links=18,                       # NVLink 4
    ici_bw_per_link=25e9,
    op_startup_ns=5_000.0,              # PLACEHOLDER: fitted by fit_h100
)

SPECS = {s.name: s for s in (TPU_V5E, TPU_V4, A64FX_CMG, A64FX_CORE,
                             CPU_HOST, H100)}
