"""Hardware design-space exploration over the model zoo (DESIGN.md §19).

A copy of ``repro.core.dse``, held bit for bit against it.  One change:
``sweep_workload`` and ``run_dse`` take ``backend="torch"`` (the fused
sweep's fixpoint passes run as the scan kernel on ``device``,
``kernels.sched_scan``, bit-identical to ``"numpy"``), and ``run_dse``
traces through the port's ``zoo.trace_phase`` (ATen captures over fake
CPU tensors), so its programs are longer than the reference's and the
two agree in rank, not in bits.

The paper's whole point is *relative* evaluation of an unbuilt chip —
gem5 tuned until rankings, not absolute cycles, are trustworthy.  This
module is that what-if service at model-step altitude: a parameterized
generator of A64FX-like candidate architectures (CMG count, cores per
CMG, HBM stacks, inter-CMG ring latency, VPU width), materialized into
``HardwareSpec``/``NodeTopology`` pairs, swept over zoo workloads as ONE
fused spec batch (``compile_node_grid`` + ``schedule_spec_sweep``) —
hundreds of candidates per program without re-running the cost pipeline
per spec.

``run_dse`` emits the ``BENCH_dse.json`` payload (schema in DESIGN.md
§16): per-workload per-candidate estimates, Pareto fronts over
(cycles, HBM bytes, cores), and a Kendall-tau ranking-stability matrix
across workloads — if the candidate ranking holds across the zoo, the
design decision does not depend on which model you benchmarked, the
property the RIKEN evaluation leaned on.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .hwspec import A64FX_CORE, HardwareSpec, NodeTopology, SpecGrid
from .memory import MemLevel
from .node import compile_node_grid, schedule_spec_sweep
from .zoo import DEFAULT_CLOCK_HZ, kendall_tau

DSE_SCHEMA = 1

# the A64FX baseline the axes scale from
_BASE_VPU_LANES = 2            # 2x512-bit FMA pipes per core
_HBM_STACK_BW = 256e9          # one HBM2 stack's aggregate per CMG
_HBM_STACK_BYTES = 8 * 2**30
_L2_READ_AGG = 900e9           # per-CMG L2 aggregates (paper values)
_L2_WRITE_AGG = 450e9


@dataclass(frozen=True)
class SpecPoint:
    """One candidate architecture: the DSE generator's coordinate tuple
    (everything else is inherited from the base spec)."""
    n_cmgs: int                  # CMGs per node
    cores_per_cmg: int
    hbm_stacks: int              # HBM2 stacks per CMG (aggregate scales)
    ring_latency_ns: float       # inter-CMG coherence hop (0 = free)
    vpu_lanes: int               # 512-bit FMA pipes per core (base: 2)
    l2_mib: float = 8.0          # per-CMG L2 capacity

    @property
    def n_cores(self) -> int:
        return self.n_cmgs * self.cores_per_cmg

    @property
    def name(self) -> str:
        return (f"c{self.n_cmgs}x{self.cores_per_cmg}"
                f"_hbm{self.hbm_stacks}_r{self.ring_latency_ns:g}"
                f"_v{self.vpu_lanes}")


def materialize(point: SpecPoint,
                base: HardwareSpec = A64FX_CORE) -> HardwareSpec:
    """Turn a :class:`SpecPoint` into a per-core spec + node topology.

    Per-core compute scales with ``vpu_lanes``; the L2/HBM *aggregates*
    scale with the topology axes while the per-core draw limits stay the
    base chip's (one core cannot saturate a stack — extra stacks pay off
    through the contention model at scale, exactly the effect the node
    engine exists to capture).  Level ``shared_by`` follows
    ``cores_per_cmg`` so the sharing domains match the candidate's CMG
    shape."""
    vs = point.vpu_lanes / _BASE_VPU_LANES
    l1 = base.memory_hierarchy()[0]
    levels = (
        l1,
        MemLevel("l2", point.l2_mib * 2**20 / point.cores_per_cmg,
                 200e9, 100e9, 20e-9, shared_by=point.cores_per_cmg),
        MemLevel("hbm2", float(point.hbm_stacks * _HBM_STACK_BYTES),
                 base.hbm_read_bw, base.hbm_write_bw, 120e-9,
                 shared_by=point.cores_per_cmg),
    )
    topo = NodeTopology(
        name=point.name, n_cmgs=point.n_cmgs,
        cores_per_cmg=point.cores_per_cmg,
        shared_read_bw={"l2": _L2_READ_AGG,
                        "hbm2": point.hbm_stacks * _HBM_STACK_BW},
        shared_write_bw={"l2": _L2_WRITE_AGG,
                         "hbm2": point.hbm_stacks * _HBM_STACK_BW},
        ring_latency_s=point.ring_latency_ns * 1e-9,
        ring_bw=115e9)
    return base.with_(
        name=point.name,
        peak_flops={k: v * vs for k, v in base.peak_flops.items()},
        vpu_flops={k: v * vs for k, v in base.vpu_flops.items()},
        mem_levels=levels,
        hbm_bytes=int(point.hbm_stacks * _HBM_STACK_BYTES),
        topology=topo)


def generate_grid(n_cmgs: Sequence[int] = (1, 2, 4, 6),
                  cores_per_cmg: Sequence[int] = (8, 12),
                  hbm_stacks: Sequence[int] = (1, 2),
                  ring_latency_ns: Sequence[float] = (0.0, 130.0),
                  vpu_lanes: Sequence[int] = (2, 4)) -> List[SpecPoint]:
    """The default DSE grid: the cross product of the five axes
    (4*2*2*2*2 = 64 candidates), A64FX at ``(4, 12, 1, 130, 2)``."""
    return [SpecPoint(c, k, h, r, v)
            for c in n_cmgs for k in cores_per_cmg for h in hbm_stacks
            for r in ring_latency_ns for v in vpu_lanes]


def spec_grid(points: Sequence[SpecPoint],
              base: HardwareSpec = A64FX_CORE) -> SpecGrid:
    """Materialize a point list into the fused sweep's ``SpecGrid``."""
    return SpecGrid([materialize(p, base) for p in points])


def pareto_front(costs: np.ndarray) -> List[int]:
    """Indices of the non-dominated rows of ``costs [N, D]`` (all axes
    minimized), in input order.  A row is dominated when some other row
    is <= everywhere and < somewhere."""
    n = len(costs)
    keep: List[int] = []
    for i in range(n):
        dominated = False
        for j in range(n):
            if j == i:
                continue
            if (costs[j] <= costs[i]).all() and (costs[j] < costs[i]).any():
                dominated = True
                break
        if not dominated:
            keep.append(i)
    return keep


def sweep_workload(prog, grid: SpecGrid, compute_dtype: str = "f32",
                   backend: str = "numpy",
                   device="cuda") -> Dict[str, np.ndarray]:
    """Fused spec sweep of one program: each candidate at its full core
    count, the fixpoint's passes on ``backend`` (``"torch"``: the scan
    kernel on ``device``).  Returns per-spec ``t_est [S]``,
    outermost-level (HBM) bytes moved ``hbm_bytes [S]`` and core counts
    ``n_cores [S]`` — the three Pareto axes."""
    ngc = compile_node_grid(prog, grid, compute_dtype=compute_dtype)
    t = schedule_spec_sweep(ngc, backend=backend,
                            device=device)[:, 0, 0]             # [S]
    bc = ngc.bc
    hbm = ((bc.rd[:, -1, :] + bc.wr[:, -1, :])
           * bc.count[:, None]).sum(axis=0)                     # [S]
    cores = np.array([grid.topology_of(s).n_cores
                      for s in range(grid.S)], dtype=float)
    return {"t_est": t, "hbm_bytes": hbm, "n_cores": cores}


def run_dse(workloads: Sequence[Tuple[str, str]],
            points: Optional[Sequence[SpecPoint]] = None,
            base: HardwareSpec = A64FX_CORE,
            compute_dtype: str = "f32",
            param_dtype: str = "float32",
            clock_hz: float = DEFAULT_CLOCK_HZ,
            hlo_cache_dir: Optional[Path] = None,
            progress=None,
            backend: str = "numpy", device="cuda") -> dict:
    """Drive the candidate grid through zoo workloads; return the
    ``BENCH_dse.json`` payload (schema ``dse`` in DESIGN.md §16).

    ``workloads`` are ``(arch, phase)`` zoo cells (captured via the
    port's ``trace_phase``, the parsed programs disk-cached under
    ``hlo_cache_dir``).  Per workload: per-candidate estimates and the
    Pareto front over (cycles, HBM bytes, cores); across workloads: the
    Kendall-tau matrix of candidate rankings.  The sweeps run on
    ``backend`` (``"torch"``: the scan kernel on ``device``).  The
    ``throughput`` block is filled by ``tools/dse_sweep_torch.py``, which
    times this fused path against the per-spec loop."""
    from .zoo import trace_phase
    points = list(points) if points is not None else generate_grid()
    grid = spec_grid(points, base)
    S = grid.S
    out: dict = {
        "schema": DSE_SCHEMA,
        "base_spec": base.name,
        "compute_dtype": compute_dtype,
        "clock_hz": clock_hz,
        "n_specs": S,
        "spec_points": [{**dataclasses.asdict(p),
                         "name": p.name, "n_cores": p.n_cores}
                        for p in points],
        "workloads": [f"{a}/{ph}" for a, ph in workloads],
        "per_workload": {},
    }
    t_cols: List[np.ndarray] = []
    for arch, phase in workloads:
        key = f"{arch}/{phase}"
        if progress:
            progress(f"dse {key}")
        prog = trace_phase(arch, phase, param_dtype=param_dtype,
                           hlo_cache_dir=hlo_cache_dir)
        sw = sweep_workload(prog, grid, compute_dtype, backend, device)
        t = sw["t_est"]
        t_cols.append(t)
        cyc = t * clock_hz
        axes = np.stack([cyc, sw["hbm_bytes"], sw["n_cores"]], axis=1)
        front = pareto_front(axes)
        best = int(np.argmin(t))
        out["per_workload"][key] = {
            "n_ops": len(prog.ops),
            "t_est_s": t.tolist(),
            "cycles": cyc.tolist(),
            "hbm_bytes": sw["hbm_bytes"].tolist(),
            "n_cores": sw["n_cores"].tolist(),
            "best_spec": points[best].name,
            "pareto": front,
            "pareto_specs": [points[i].name for i in front],
        }
    W = len(t_cols)
    taus = np.ones((W, W))
    for i in range(W):
        for j in range(i + 1, W):
            taus[i, j] = taus[j, i] = kendall_tau(
                list(t_cols[i]), list(t_cols[j]))
    off = [taus[i, j] for i in range(W) for j in range(W) if i != j]
    out["rank_stability"] = {
        "tau_matrix": [[float(v) for v in row] for row in taus],
        "mean_tau": float(np.mean(off)) if off else 1.0,
        "min_tau": float(np.min(off)) if off else 1.0,
    }
    return out
