"""Model-zoo estimation pipeline: every registry config through the node engine.

A copy of ``repro.core.zoo`` whose frontend is the port's own.  The paper's
end goal is estimating execution cycles of *one-node applications* — not
isolated kernels — with accuracy good enough for relative evaluation and
tuning.  This module is that step (DESIGN.md §15): it drives the whole
``configs.registry`` model zoo through the port's model stack and the
multi-core node engine, one pipeline:

1. **Trace** — each architecture's representative phases (one train step,
   one prefill, one decode step; ``configs.shapes.ZOO_SHAPES``) are
   captured as ATen graphs (``core.aten.capture`` over fake tensors on the
   CPU: nothing runs and nothing of the model is allocated) at
   structure-preserving reduced width (``reduced_config``), where the
   reference lowers and compiles with ``jax.jit``, and parsed into a
   costed :class:`~.hlo.Program` by ``aten.parse_graph``.  Traces are
   memoized in-process (the built model is shared across a config's
   phases) and optionally on disk, as the parsed ``Program`` in JSON.
2. **Estimate** — each program is sharded over the
   :class:`~.hwspec.NodeTopology` and scheduled by the contention-aware
   node engine (``core.node``, DESIGN.md §14) across a core-count axis,
   and the batched O3 knob grid runs as one fused core-count x knob
   sweep (``core.node.schedule_node_sweep``, DESIGN.md §17): with
   ``backend="torch"`` its passes run as the scan kernel on ``device``
   (``kernels.sched_scan``), bit-identical to ``"numpy"``.
3. **Rank** — per phase, models are ranked by estimated time at every core
   count, and Kendall-tau rank correlations across the core-count axis
   (plus against traced FLOPs) quantify rank *stability*.

An ATen capture is eager and unrolled (every op has ``count`` 1), where
XLA collapses the layer loops into counted ops, so the port's programs are
longer than the reference's and the two zoos agree in rank, not in bits.

``tools/model_zoo_torch.py`` is the CLI (``BENCH_model_zoo_torch.json``,
DESIGN.md §16's schema).  ``serving_cell_cost`` prices the serving
simulator's cells (``core.serving``), disk-cached under a key that hashes
``FRONTEND_SCHEMA`` where the reference hashes its HLO cache schema.
``run_cluster`` drives the cluster engine (``core.cluster``) over the
zoo's train traces, its shard axes resolved by the port's
``parallel.sharding.MeshRules`` (``mesh_rules_resolver``);
``tools/cluster_scaling_torch.py`` is its CLI.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..configs import ARCHS, ZOO_SHAPES, reduced_config, zoo_phases_for
from ..configs.base import ModelConfig, ShapeConfig
from .cluster import ClusterResult, ClusterWorkload, ShardDecision, \
    cluster_sweep
from .cost import cost_program
from .hlo import OpStat, Program
from .hwspec import A64FX_CORE, ClusterTopology, HardwareSpec, NodeTopology
from .node import compile_node, schedule_node, schedule_node_sweep
from .roofline import roofline_from_program
from .sample import SamplePlan, SamplingConfig, sample_program, \
    sampled_node_sweep, sampled_schedule_node, unroll_program

#: Core counts the default sweep estimates at: one core, one full CMG,
#: the whole 4-CMG node (mirrors the kernel suite's node section).
DEFAULT_CORE_COUNTS: Tuple[int, ...] = (1, 12, 48)

#: Node counts the cluster sweep scales over (powers of two to a rack-
#: scale 1024; the ROADMAP's "Fugaku-shaped mesh" open item).
DEFAULT_NODE_COUNTS: Tuple[int, ...] = (2, 4, 8, 16, 32, 64, 128, 256,
                                        512, 1024)

#: The cluster bench's default models: the largest MoE (expert
#: parallelism in play) and the largest dense config in the registry.
DEFAULT_CLUSTER_MODELS: Tuple[str, ...] = ("grok-1-314b",
                                           "nemotron-4-340b")

#: A64FX clock — node times convert to the paper's execution-cycle unit.
DEFAULT_CLOCK_HZ = 1.8e9

# compact O3 knob subsets for the zoo's batched grid (12 combos; the full
# calibrate grid is 90 — overkill per (model, phase, core count) cell)
ZOO_O3_WINDOWS = (16, 64, 256)
ZOO_O3_MEM_WIDTHS = (1, 2)
ZOO_O3_VPU_WIDTHS = (1, 2)
ZOO_O3_QUEUE_DEPTHS = (16,)

#: The frontend's schema counter: bump to invalidate every on-disk trace
#: when the capture or ``aten.parse_graph``'s rules change what a cached
#: Program means.
FRONTEND_SCHEMA = 1

#: The serving cost cells' schema counter (``serving_cell_cost``).
SERVING_COST_SCHEMA = 1

# ----------------------------------------------------------------- tracing
# arch -> (config, model); shared across phases so one build serves
# train + prefill + decode
_MODEL_CACHE: Dict[str, tuple] = {}
# (arch, phase, seq_len, global_batch, param_dtype) -> Program
_PROGRAM_CACHE: Dict[tuple, Program] = {}


def clear_trace_caches() -> None:
    """Drop the in-process model/program memos (tests use this)."""
    _MODEL_CACHE.clear()
    _PROGRAM_CACHE.clear()


def zoo_config(arch: str) -> ModelConfig:
    """The config the zoo traces for ``arch``: the structure-preserving
    reduced form (same family/MoE/SSM/GQA/enc-dec features, toy width)."""
    return reduced_config(ARCHS[arch])


def phase_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for the roofline: 6·N_active·D (train), 2·N_active·D
    (prefill), 2·N_active·B (decode: one token per sequence)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch


def _traced_model(arch: str):
    """(config, model) of ``arch``, built with ``build_model``'s defaults
    (``blocked`` attention, the ``chunked`` SSD scan), as the reference's
    zoo builds with its own."""
    from ..models.lm import build_model
    hit = _MODEL_CACHE.get(arch)
    if hit is None:
        cfg = zoo_config(arch)
        hit = _MODEL_CACHE[arch] = (cfg, build_model(cfg))
    return hit


def hlo_cache_key(arch: str, phase: str, shape: ShapeConfig,
                  param_dtype: str) -> str:
    """Content hash of everything a cached trace depends on: the FULL
    reduced model config, the shape, the dtype, the phase and
    ``FRONTEND_SCHEMA``.  The phase must be in the key: the zoo's prefill
    and decode shapes are identical (``ZOO_PREFILL``/``ZOO_DECODE``)."""
    cfg = zoo_config(arch)
    payload = json.dumps({
        "frontend": "aten",
        "schema": FRONTEND_SCHEMA,
        "config": dataclasses.asdict(cfg),
        "shape": dataclasses.asdict(shape),
        "phase": phase,
        "param_dtype": param_dtype,
    }, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


def hlo_cache_path(cache_dir: Path, arch: str, phase: str,
                   shape: ShapeConfig, param_dtype: str) -> Path:
    """Cache file for one (arch, phase) cell: human-readable prefix +
    content hash, so a config/shape/schema change misses instead of
    reading a stale trace."""
    h = hlo_cache_key(arch, phase, shape, param_dtype)
    return Path(cache_dir) / (
        f"{arch}__{phase}_s{shape.seq_len}b{shape.global_batch}"
        f"_{param_dtype}.{h}.program.json")


def program_to_json(prog: Program) -> str:
    """A ``Program`` as JSON text; :func:`program_from_json` inverts it
    exactly (floats round-trip through ``repr``)."""
    return json.dumps({"entry": prog.entry,
                       "n_partitions": prog.n_partitions,
                       "exact_dtypes": bool(prog.exact_dtypes),
                       "ops": [dataclasses.asdict(o) for o in prog.ops]})


def program_from_json(text: str) -> Program:
    d = json.loads(text)
    ops = []
    for o in d["ops"]:
        if o["dot_dims"] is not None:
            o["dot_dims"] = tuple(o["dot_dims"])
        ops.append(OpStat(**o))
    prog = Program(ops=ops, entry=d["entry"], n_partitions=d["n_partitions"])
    if d["exact_dtypes"]:
        prog.exact_dtypes = True
    return prog


def _phase_graph(arch: str, phase: str, shape: ShapeConfig,
                 param_dtype: str):
    """Capture one (arch, phase) cell as an ATen graph over fake CPU
    tensors: the train step with its optimizer state, the prefill, or one
    decode step over ``cache_abstract``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs.base import RunConfig
    from ..models import params as pr
    from ..serve.engine import make_decode_step, make_prefill_step
    from ..serve.kvcache import cache_abstract
    from ..train.trainer import make_train_step
    from . import aten

    cfg, model = _traced_model(arch)
    pdt = getattr(torch, param_dtype)
    with FakeTensorMode():
        params = pr.tree_map(
            lambda p: torch.empty(p.shape, dtype=pr.leaf_dtype(p, pdt)),
            model.param_specs())
        batch = {k: (torch.empty(v.shape, dtype=v.dtype)
                     if isinstance(v, torch.Tensor) else v)
                 for k, v in model.input_specs(shape, pdt).items()}
        if phase == "train":
            run = RunConfig(model=cfg, shape=shape, param_dtype=param_dtype,
                            compute_dtype=param_dtype)
            step, *_, opt_init = make_train_step(model, run)
            args = (params, opt_init(params), batch)
        elif phase == "prefill":
            prefill = make_prefill_step(model)

            def step(params, batch):
                with torch.no_grad():
                    return prefill(params, batch)
            args = (params, batch)
        elif phase == "decode":
            decode = make_decode_step(model)

            def step(params, cache, batch):
                with torch.no_grad():
                    return decode(params, cache, batch)
            args = (params, cache_abstract(model, shape.global_batch,
                                           shape.seq_len, pdt, "cpu"), batch)
        else:
            raise ValueError(f"unknown zoo phase {phase!r}")
    return aten.capture(step, *args)


def trace_phase(arch: str, phase: str,
                shape: Optional[ShapeConfig] = None,
                param_dtype: str = "float32",
                hlo_cache_dir: Optional[Path] = None) -> Program:
    """Trace one (architecture, phase) cell into a parsed ``Program``.

    Memoized in-process on (arch, phase, shape, dtype); ``hlo_cache_dir``
    additionally persists the parsed Program as JSON across processes
    (the CLI's warm path: reading is milliseconds, the capture seconds).
    """
    from .aten import parse_graph
    if phase not in ZOO_SHAPES and shape is None:
        raise ValueError(f"unknown zoo phase {phase!r}; "
                         f"known: {sorted(ZOO_SHAPES)}")
    shape = shape or ZOO_SHAPES[phase]
    key = (arch, phase, shape.seq_len, shape.global_batch, param_dtype)
    prog = _PROGRAM_CACHE.get(key)
    cache_file = None
    if hlo_cache_dir is not None:
        cache_file = hlo_cache_path(Path(hlo_cache_dir), arch, phase,
                                    shape, param_dtype)
        if prog is None and cache_file.exists():
            prog = program_from_json(cache_file.read_text())
    if prog is None:
        prog = parse_graph(_phase_graph(arch, phase, shape, param_dtype))
    # persisted even where the program came from this process's memo
    if cache_file is not None and not cache_file.exists():
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        cache_file.write_text(program_to_json(prog))
    _PROGRAM_CACHE[key] = prog
    return prog


def long_trace_repeats(arch: str, phase: str,
                       decode_steps: int = 64) -> int:
    """How many copies of the traced step the full-width/full-depth trace
    concatenates: the full/reduced layer-count ratio for ``train`` and
    ``prefill``, ``decode_steps`` near-identical token steps for
    ``decode``."""
    if phase == "decode":
        return max(1, int(decode_steps))
    full = ARCHS[arch].n_layers
    reduced = zoo_config(arch).n_layers
    return max(1, -(-full // max(reduced, 1)))      # ceil div


def trace_long_phase(arch: str, phase: str,
                     shape: Optional[ShapeConfig] = None,
                     param_dtype: str = "float32",
                     hlo_cache_dir: Optional[Path] = None,
                     decode_steps: int = 64,
                     repeats: Optional[int] = None) -> Tuple[Program, int]:
    """The full-depth/multi-step trace of one zoo cell: the reduced trace
    of :func:`trace_phase` unrolled ``repeats`` times
    (:func:`~.sample.unroll_program`).  Returns ``(program, repeats)``."""
    step = trace_phase(arch, phase, shape, param_dtype, hlo_cache_dir)
    r = repeats if repeats is not None else \
        long_trace_repeats(arch, phase, decode_steps)
    return unroll_program(step, r), r


# ------------------------------------------------------- serving cost cells
def serving_cost_key(arch: str, phase: str, shape: ShapeConfig,
                     n_cores: int, compute_dtype: str,
                     param_dtype: str) -> str:
    """Content hash for one serving cost cell (``serving_cell_cost``).

    The hash covers everything the cached estimate depends on — the full
    reduced config, the shape, the core count, both dtypes, both schema
    counters — and the ``phase`` string itself.  The phase MUST be in the
    key: the zoo's reduced prefill and decode shapes are deliberately
    identical (``ZOO_PREFILL``/``ZOO_DECODE``: seq 256, batch 2), so a
    shape-only key would silently serve a prefill estimate for a decode
    cell.
    """
    cfg = zoo_config(arch)
    payload = json.dumps({
        "schema": SERVING_COST_SCHEMA,
        "frontend_schema": FRONTEND_SCHEMA,
        "config": dataclasses.asdict(cfg),
        "shape": dataclasses.asdict(shape),
        "phase": phase,
        "n_cores": n_cores,
        "compute_dtype": compute_dtype,
        "param_dtype": param_dtype,
    }, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


def serving_cell_cost(arch: str, phase: str,
                      shape: Optional[ShapeConfig] = None,
                      n_cores: int = 48,
                      hw: HardwareSpec = A64FX_CORE,
                      topology: Optional[NodeTopology] = None,
                      compute_dtype: str = "f32",
                      param_dtype: str = "float32",
                      hlo_cache_dir: Optional[Path] = None,
                      cost_cache_dir: Optional[Path] = None) -> float:
    """Node-engine ``t_est_s`` of one (arch, phase, shape) serving cell.

    The serving simulator (``core.serving``, DESIGN.md §21) prices prefill
    and decode iterations from these cells; ``cost_cache_dir`` persists
    each estimate as a small JSON file so serving sweeps never re-capture
    or re-schedule a cell.  The file name embeds the phase AND the content
    hash of :func:`serving_cost_key` — prefill/decode cells at the zoo's
    equal reduced shapes land in different files with different hashes.
    """
    shape = shape or ZOO_SHAPES[phase]
    cpath = None
    if cost_cache_dir is not None:
        key = serving_cost_key(arch, phase, shape, n_cores,
                               compute_dtype, param_dtype)
        cpath = Path(cost_cache_dir) / (
            f"{arch}__serve_{phase}_s{shape.seq_len}b{shape.global_batch}"
            f"_{n_cores}c.{key}.json")
        if cpath.exists():
            return float(json.loads(cpath.read_text())["t_est_s"])
    prog = trace_phase(arch, phase, shape, param_dtype, hlo_cache_dir)
    pe = estimate_program(prog, hw, (n_cores,),
                          topology or hw.topology, "shard", compute_dtype,
                          arch=arch, phase=phase)
    t = float(pe.at(n_cores).t_est_s)
    if cpath is not None:
        cpath.parent.mkdir(parents=True, exist_ok=True)
        cpath.write_text(json.dumps({
            "schema": SERVING_COST_SCHEMA, "arch": arch, "phase": phase,
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "n_cores": n_cores, "t_est_s": t}, indent=1))
    return t


# ------------------------------------------------------------- rank utility
def kendall_tau(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Kendall tau-b (tie-corrected) rank correlation; O(n²), n is tiny."""
    n = len(xs)
    conc = disc = tie_x = tie_y = 0
    for i in range(n):
        for j in range(i + 1, n):
            dx = xs[i] - xs[j]
            dy = ys[i] - ys[j]
            if dx == 0 and dy == 0:
                tie_x += 1
                tie_y += 1
            elif dx == 0:
                tie_x += 1
            elif dy == 0:
                tie_y += 1
            elif (dx > 0) == (dy > 0):
                conc += 1
            else:
                disc += 1
    n0 = n * (n - 1) / 2
    denom = ((n0 - tie_x) * (n0 - tie_y)) ** 0.5
    return (conc - disc) / denom if denom > 0 else 0.0


# ------------------------------------------------------------------ results
@dataclass
class CoreCountEstimate:
    """Node-engine estimate of one (model, phase) program at one core count."""
    n_cores: int
    t_est_s: float                   # contention-aware node makespan
    t_zero_contention_s: float       # fixpoint iteration 0 (lower bound)
    parallel_efficiency: float       # busy / (cores x makespan)
    bound_by: str                    # binding port of the node schedule
    shared_n_active: Dict[str, float] = field(default_factory=dict)
    # batched O3 knob grid riding the same compiled form (0.0 = grid off)
    t_best_knobs_s: float = 0.0
    best_knobs: Optional[Dict[str, int]] = None

    def cycles(self, clock_hz: float = DEFAULT_CLOCK_HZ) -> float:
        """Execution cycles at ``clock_hz`` — the paper's headline unit."""
        return self.t_est_s * clock_hz


@dataclass
class PhaseEstimate:
    """One (model, phase) row: program summary + per-core-count estimates."""
    arch: str
    phase: str
    n_ops: int                       # parsed ops
    n_costed: int                    # ops the cost model charges
    flops: float
    bytes_accessed: float
    roofline_dominant: str           # compute | memory | collective
    roofline_fraction: float
    per_core: List[CoreCountEstimate] = field(default_factory=list)
    # sampled-estimation metadata (None = every op scheduled); the long
    # full-depth trace mode records its unroll factor in trace_repeats
    sampling: Optional[Dict[str, float]] = None
    trace_repeats: int = 1

    def at(self, n_cores: int) -> CoreCountEstimate:
        """The estimate at one swept core count (KeyError if not swept)."""
        for ce in self.per_core:
            if ce.n_cores == n_cores:
                return ce
        raise KeyError(f"core count {n_cores} not swept for "
                       f"{self.arch}/{self.phase}")

    @property
    def node_speedup(self) -> float:
        """t_est at the smallest swept core count / at the largest."""
        if not self.per_core:
            return 1.0
        lo = min(self.per_core, key=lambda c: c.n_cores)
        hi = max(self.per_core, key=lambda c: c.n_cores)
        return lo.t_est_s / max(hi.t_est_s, 1e-30)


@dataclass
class ZooReport:
    """The full zoo sweep: estimates + rank tables + stability taus."""
    hw: str
    topology: str
    partition: str
    compute_dtype: str
    clock_hz: float
    core_counts: Tuple[int, ...]
    phases: Tuple[str, ...]
    # arch -> phase -> PhaseEstimate
    estimates: Dict[str, Dict[str, PhaseEstimate]] = field(
        default_factory=dict)
    wall_s: float = 0.0

    def rank_table(self, phase: str, n_cores: int) -> List[str]:
        """Archs ranked fastest-first by node ``t_est`` for one phase at
        one core count (archs missing the phase are omitted)."""
        rows = [(est[phase].at(n_cores).t_est_s, arch)
                for arch, est in self.estimates.items() if phase in est]
        return [arch for _, arch in sorted(rows)]

    def rank_stability(self, phase: str) -> Dict[str, float]:
        """Kendall taus for one phase: between every adjacent pair of the
        core-count axis (``"1->12"`` style keys), their ``min``, and
        ``vs_flops`` (estimate order vs traced-work order)."""
        archs = [a for a, est in self.estimates.items() if phase in est]
        t = {k: [self.estimates[a][phase].at(k).t_est_s for a in archs]
             for k in self.core_counts}
        out: Dict[str, float] = {}
        pair_taus = []
        for lo, hi in zip(self.core_counts, self.core_counts[1:]):
            tau = kendall_tau(t[lo], t[hi])
            out[f"{lo}->{hi}"] = tau
            pair_taus.append(tau)
        out["min"] = min(pair_taus) if pair_taus else 1.0
        work = [self.estimates[a][phase].flops for a in archs]
        out["vs_flops"] = kendall_tau(work, t[min(self.core_counts)])
        return out

    def to_dict(self) -> dict:
        """The ``BENCH_model_zoo*.json`` payload (schema: DESIGN.md §16)."""
        models: Dict[str, dict] = {}
        for arch, by_phase in self.estimates.items():
            cfg = zoo_config(arch) if arch in ARCHS else None
            phases = {}
            for phase, pe in by_phase.items():
                phases[phase] = {
                    "n_ops": pe.n_ops,
                    "n_costed": pe.n_costed,
                    "flops": pe.flops,
                    "bytes_accessed": pe.bytes_accessed,
                    "roofline_dominant": pe.roofline_dominant,
                    "roofline_fraction": pe.roofline_fraction,
                    "node_speedup": pe.node_speedup,
                    "sampling": pe.sampling,
                    "trace_repeats": pe.trace_repeats,
                    "per_core": {
                        str(ce.n_cores): {
                            "t_est_us": ce.t_est_s * 1e6,
                            "cycles": ce.cycles(self.clock_hz),
                            "t_zero_contention_us":
                                ce.t_zero_contention_s * 1e6,
                            "parallel_efficiency": ce.parallel_efficiency,
                            "bound_by": ce.bound_by,
                            "shared_n_active": ce.shared_n_active,
                            "t_best_knobs_us": ce.t_best_knobs_s * 1e6,
                            "best_knobs": ce.best_knobs,
                        } for ce in pe.per_core},
                }
            models[arch] = {
                "family": cfg.family if cfg else "",
                "param_count": cfg.param_count() if cfg else 0,
                "active_param_count": (ARCHS[arch].active_param_count()
                                       if arch in ARCHS else 0),
                "phases": phases,
            }
        rank = {ph: {str(k): self.rank_table(ph, k)
                     for k in self.core_counts}
                for ph in self.phases}
        taus = {ph: self.rank_stability(ph) for ph in self.phases}
        return {
            "schema": 1,
            "hw": self.hw,
            "topology": self.topology,
            "partition": self.partition,
            "compute_dtype": self.compute_dtype,
            "clock_ghz": self.clock_hz / 1e9,
            "core_counts": list(self.core_counts),
            "phases": list(self.phases),
            "models": models,
            "rank": rank,
            "kendall_tau": taus,
            "wall_s": self.wall_s,
        }

    def to_json(self) -> str:
        """:meth:`to_dict` as the CLI writes it."""
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)


# ------------------------------------------------------------- the pipeline
def estimate_program(prog: Program, hw: HardwareSpec = A64FX_CORE,
                     core_counts: Sequence[int] = DEFAULT_CORE_COUNTS,
                     topology: Optional[NodeTopology] = None,
                     partition: str = "shard",
                     compute_dtype: str = "f32",
                     model_flops: float = 0.0,
                     o3_knobs=None,
                     arch: str = "", phase: str = "",
                     sampling: Optional[SamplingConfig] = None,
                     backend: str = "numpy", device="cuda"
                     ) -> PhaseEstimate:
    """Estimate one traced program across the core-count axis.

    The program is costed once (``compile_node`` memoizes the node form on
    the ``Program``); only the node schedule reruns per core count.  When
    ``o3_knobs`` (an :class:`~.compiled.O3Knobs` batch) is given, the
    whole core-count x knob grid runs as ONE fused batch of the batched
    node engine — on ``backend`` (``"torch"``: the scan kernel on
    ``device``) — and the best combo per count is recorded.

    ``sampling`` switches every schedule in the cell to the SimPoint-style
    sampled path (``core.sample``, DESIGN.md §18): the program is sliced,
    clustered ONCE, and only cluster representatives are scheduled at
    each core count / knob combo.
    """
    topo = topology or hw.topology or NodeTopology.degenerate(
        max(core_counts))
    rf = roofline_from_program(prog, hw, 1, model_flops, compute_dtype)
    plan: Optional[SamplePlan] = None
    if sampling is not None:
        costed = cost_program(prog, hw, compute_dtype=compute_dtype)
        plan = sample_program(prog, hw, sampling, compute_dtype, costed)
        n_costed = sum(1 for ot in costed if ot is not None)
    else:
        nc = compile_node(prog, hw, compute_dtype=compute_dtype)
        n_costed = int(nc.costed_mask.sum())
    pe = PhaseEstimate(
        arch=arch, phase=phase, n_ops=len(prog.ops),
        n_costed=n_costed,
        flops=prog.flops, bytes_accessed=prog.bytes_accessed,
        roofline_dominant=rf.dominant,
        roofline_fraction=rf.roofline_fraction)
    if plan is not None:
        pe.sampling = {
            "k": plan.k, "n_intervals": plan.n_intervals,
            "interval_ops": plan.config.interval_ops,
            "seed": plan.config.seed,
            "frac_ops_scheduled": plan.frac_ops_scheduled,
        }
    knob_ts = None
    if o3_knobs is not None:
        if plan is not None:
            knob_ts, _ = sampled_node_sweep(
                prog, hw, o3_knobs, core_counts, topology=topo,
                partition=partition, compute_dtype=compute_dtype,
                plan=plan, backend=backend, device=device)
        else:
            knob_ts = schedule_node_sweep(nc, hw, o3_knobs, core_counts,
                                          topology=topo,
                                          partition=partition,
                                          backend=backend, device=device)
    for ki, k in enumerate(core_counts):
        if plan is not None:
            sr = sampled_schedule_node(
                prog, hw, k, topology=topo, partition=partition,
                compute_dtype=compute_dtype, plan=plan)
            ce = CoreCountEstimate(
                n_cores=k, t_est_s=sr.t_est,
                t_zero_contention_s=sr.t_zero_contention,
                parallel_efficiency=sr.parallel_efficiency,
                bound_by=sr.bound_by)
        else:
            nr = schedule_node(nc, hw, k, topology=topo,
                               partition=partition)
            ce = CoreCountEstimate(
                n_cores=k, t_est_s=nr.t_est,
                t_zero_contention_s=nr.t_zero_contention,
                parallel_efficiency=nr.parallel_efficiency,
                bound_by=nr.schedule.bound_by,
                shared_n_active=dict(nr.per_cmg[0].n_active))
        if knob_ts is not None:
            ts = knob_ts[ki]
            best = int(ts.argmin())
            ce.t_best_knobs_s = float(ts[best])
            ce.best_knobs = {
                "inflight_window": int(o3_knobs.window[best]),
                "mem_issue_width": int(o3_knobs.width[best, 2]),
                "vpu_issue_width": int(o3_knobs.width[best, 1]),
                "queue_depth": int(o3_knobs.depth[best, 2]),
            }
        pe.per_core.append(ce)
    return pe


def zoo_workloads(models: Sequence[str],
                  phases: Sequence[str]) -> List[Tuple[str, str]]:
    """Validated ``(arch, phase)`` cells: the cross product of ``models``
    and ``phases``, checked against the registry and each architecture's
    supported phases — a typo fails here, not deep into a sweep."""
    out: List[Tuple[str, str]] = []
    for m in models:
        if m not in ARCHS:
            raise ValueError(f"unknown arch {m!r}; known: {sorted(ARCHS)}")
        supported = zoo_phases_for(ARCHS[m])
        for ph in phases:
            if ph not in ZOO_SHAPES:
                raise ValueError(f"unknown phase {ph!r}; "
                                 f"known: {sorted(ZOO_SHAPES)}")
            if ph in supported:
                out.append((m, ph))
    if not out:
        raise ValueError("no (arch, phase) cells survived filtering")
    return out


def zoo_o3_knobs(hw: HardwareSpec):
    """The zoo's compact batched knob grid (12 combos around ``hw``)."""
    from .calibrate import default_o3_knobs
    return default_o3_knobs(hw, windows=ZOO_O3_WINDOWS,
                            mem_widths=ZOO_O3_MEM_WIDTHS,
                            vpu_widths=ZOO_O3_VPU_WIDTHS,
                            queue_depths=ZOO_O3_QUEUE_DEPTHS)


def run_zoo(models: Optional[Sequence[str]] = None,
            phases: Optional[Sequence[str]] = None,
            hw: HardwareSpec = A64FX_CORE,
            core_counts: Sequence[int] = DEFAULT_CORE_COUNTS,
            topology: Optional[NodeTopology] = None,
            partition: str = "shard",
            compute_dtype: str = "f32",
            param_dtype: str = "float32",
            clock_hz: float = DEFAULT_CLOCK_HZ,
            with_o3_grid: bool = True,
            hlo_cache_dir: Optional[Path] = None,
            progress=None,
            long_traces: bool = False,
            decode_steps: int = 64,
            sampling: Optional[SamplingConfig] = None,
            backend: str = "numpy", device="cuda") -> ZooReport:
    """Trace + estimate + rank the model zoo end to end.

    ``models`` defaults to every config in ``configs.registry.ARCHS``;
    ``phases`` defaults to each model's ``zoo_phases_for`` set.  The O3
    grid's sweeps run on ``backend`` (``"torch"``: the scan kernel on
    ``device``).  ``long_traces`` switches every cell to the
    full-depth/multi-step trace (:func:`trace_long_phase`), affordable
    only with ``sampling`` (a :class:`~.sample.SamplingConfig`; DESIGN.md
    §18).  A non-positive ``sampling.interval_ops`` means *auto*: one
    interval per traced step.
    """
    t0 = time.perf_counter()
    names = list(models) if models is not None else sorted(ARCHS)
    topo = topology or hw.topology
    knobs = zoo_o3_knobs(hw) if with_o3_grid else None
    report = ZooReport(
        hw=hw.name, topology=(topo.name if topo else "degenerate"),
        partition=partition, compute_dtype=compute_dtype,
        clock_hz=clock_hz, core_counts=tuple(core_counts),
        phases=tuple(phases) if phases is not None
        else tuple(ZOO_SHAPES))
    for arch in names:
        cfg = zoo_config(arch)
        arch_phases = (tuple(phases) if phases is not None
                       else zoo_phases_for(cfg))
        report.estimates[arch] = {}
        for phase in arch_phases:
            tp0 = time.perf_counter()
            repeats = 1
            if long_traces:
                prog, repeats = trace_long_phase(
                    arch, phase, param_dtype=param_dtype,
                    hlo_cache_dir=hlo_cache_dir,
                    decode_steps=decode_steps)
            else:
                prog = trace_phase(arch, phase, param_dtype=param_dtype,
                                   hlo_cache_dir=hlo_cache_dir)
            cell_sampling = sampling
            if sampling is not None and sampling.interval_ops <= 0:
                step_inst = sum(o.count for o in prog.ops) / repeats
                cell_sampling = dataclasses.replace(
                    sampling, interval_ops=max(step_inst, 1.0))
            pe = estimate_program(
                prog, hw, core_counts, topo, partition, compute_dtype,
                model_flops=phase_model_flops(cfg, ZOO_SHAPES[phase]),
                o3_knobs=knobs, arch=arch, phase=phase,
                sampling=cell_sampling, backend=backend, device=device)
            pe.trace_repeats = repeats
            report.estimates[arch][phase] = pe
            if progress is not None:
                progress(arch, phase, pe, time.perf_counter() - tp0)
    report.wall_s = time.perf_counter() - t0
    return report


# --------------------------------------------------------- cluster driver
def cluster_workload(arch: str, phase: str = "train",
                     shape: Optional[ShapeConfig] = None,
                     param_dtype: str = "float32",
                     hlo_cache_dir: Optional[Path] = None,
                     decode_steps: int = 64) -> ClusterWorkload:
    """Build one model's :class:`~.cluster.ClusterWorkload` from the zoo
    trace: the reduced one-step program plus the shape facts the cluster
    engine sizes collective payloads with (DESIGN.md §20).

    Units are the zoo's reduced-trace units throughout — ``d_model``,
    ``param_bytes`` and the activation payloads all come from the
    reduced config, matching the traced compute so the collective/
    compute *ratio* is structure-true even though absolute bytes are
    toy-width.  ``frac_attn`` (the attention share of per-layer work,
    which decides how much compute a tensor shard removes) comes from
    the FULL config's per-layer parameter split — that ratio is what the
    reduced form does NOT preserve.
    """
    full = ARCHS[arch]
    rcfg = zoo_config(arch)
    shape = shape or ZOO_SHAPES[phase]
    prog = trace_phase(arch, phase, shape, param_dtype, hlo_cache_dir)
    repeats = long_trace_repeats(arch, phase, decode_steps)
    d, hd = full.d_model, full.head_dim
    attn = d * full.n_heads * hd + 2 * d * full.n_kv_heads * hd \
        + full.n_heads * hd * d
    glu = 3 if full.mlp_kind in ("swiglu", "geglu") else 2
    active_k = full.moe.top_k if full.moe is not None else 1
    ffn = glu * d * full.d_ff * max(active_k, 1)
    frac_attn = attn / (attn + ffn) if full.n_heads else 0.0
    return ClusterWorkload(
        name=arch, prog=prog, repeats=repeats, layers=rcfg.n_layers,
        d_model=rcfg.d_model, seq_len=shape.seq_len,
        batch=shape.global_batch,
        # full traced depth in reduced-width units (the grad-sync payload)
        param_bytes=float(rcfg.param_count()) * 4.0 * repeats,
        frac_attn=frac_attn,
        moe_top_k=full.moe.top_k if full.moe is not None else 0)


def mesh_rules_resolver(arch: str):
    """Shard-axis resolution for the cluster engine, delegated to the
    REAL sharding table: a logical (data=1, model=tp) mesh duck-type
    through ``parallel.sharding.MeshRules.param_spec`` on the FULL
    config's parameter shapes — so the cluster engine inherits the
    MeshRules divisibility fallback verbatim (grok's 8 experts ride
    expert parallelism at tp<=8 but fall back to expert-TP via 'mlp' at
    tp=16, exactly as the dry-run shards it).
    """
    cfg = ARCHS[arch]

    def resolve(tp: int) -> ShardDecision:
        if tp <= 1:
            return ShardDecision(attn=False, mlp=False, experts=False)
        from ..parallel.sharding import MeshRules

        class _Devices:
            shape = (1, tp)

        class _Mesh:
            axis_names = ("data", "model")
            devices = _Devices()

        rules = MeshRules(mesh=_Mesh())

        def on_model(entry) -> bool:
            if entry is None:
                return False
            if isinstance(entry, tuple):
                return "model" in entry
            return entry == "model"

        d, hd = cfg.d_model, cfg.head_dim
        wq = rules.param_spec(("embed", "heads", "head_dim"),
                              (d, cfg.n_heads, hd))
        attn = on_model(wq[1]) or on_model(wq[2])
        if cfg.moe is not None:
            we = rules.param_spec(("experts", "embed", "mlp"),
                                  (cfg.moe.n_experts, d, cfg.d_ff))
            experts = on_model(we[0])
            mlp = on_model(we[2])
        else:
            experts = False
            wi = rules.param_spec(("embed", "mlp"), (d, cfg.d_ff))
            mlp = on_model(wi[1])
        return ShardDecision(attn=attn, mlp=mlp, experts=experts)

    return resolve


@dataclass
class ClusterReport:
    """The cluster sweep: every (model, node count, plan) cell + ranks."""
    hw: str
    topology: str                    # node topology name
    cluster: str                     # interconnect family (e.g. tofu_d)
    n_cores: int
    compute_dtype: str
    node_counts: Tuple[int, ...]
    # model -> every swept ClusterResult
    results: Dict[str, List[ClusterResult]] = field(default_factory=dict)
    wall_s: float = 0.0

    def cells(self, model: str, n_nodes: int) -> List[ClusterResult]:
        return [r for r in self.results.get(model, ())
                if r.n_nodes == n_nodes]

    def best(self, model: str, n_nodes: int) -> ClusterResult:
        """The winning plan (min step time) for one (model, node count)."""
        cells = self.cells(model, n_nodes)
        if not cells:
            raise KeyError(f"no cells for {model} at {n_nodes} nodes")
        return min(cells, key=lambda r: r.t_step_s)

    def rank_table(self, n_nodes: int) -> List[str]:
        """Models ranked fastest-first by their best plan's step time."""
        rows = [(self.best(m, n_nodes).t_step_s, m)
                for m in self.results if self.cells(m, n_nodes)]
        return [m for _, m in sorted(rows)]

    def plan_rank_stability(self, model: str) -> Dict[str, float]:
        """Kendall taus of the PLAN ranking between adjacent node counts,
        over the (tp, pp) structures present at both — the cluster
        analogue of the zoo's core-count rank stability: does the
        parallel-efficiency ordering of plans survive scaling?"""
        by_n: Dict[int, Dict[Tuple[int, int], float]] = {}
        for r in self.results.get(model, ()):
            by_n.setdefault(r.n_nodes, {})[(r.plan.tp, r.plan.pp)] = \
                r.t_step_s
        out: Dict[str, float] = {}
        taus = []
        for lo, hi in zip(self.node_counts, self.node_counts[1:]):
            common = sorted(set(by_n.get(lo, {})) & set(by_n.get(hi, {})))
            if len(common) < 2:
                continue
            tau = kendall_tau([by_n[lo][s] for s in common],
                              [by_n[hi][s] for s in common])
            out[f"{lo}->{hi}"] = tau
            taus.append(tau)
        out["min"] = min(taus) if taus else 1.0
        return out

    def to_dict(self) -> dict:
        """The ``BENCH_cluster.json`` payload (schema: DESIGN.md §16)."""
        models: Dict[str, dict] = {}
        for name, rows in self.results.items():
            plans: Dict[str, dict] = {}
            scaling: Dict[str, dict] = {}
            best_plan: Dict[str, str] = {}
            for r in rows:
                n = str(r.n_nodes)
                plans.setdefault(n, {})[r.plan.label] = {
                    "t_step_us": r.t_step_s * 1e6,
                    "t_sched_us": r.t_sched_s * 1e6,
                    "t_floor_us": r.t_floor_s * 1e6,
                    "parallel_efficiency": r.parallel_efficiency,
                    "tokens_per_s": r.tokens_per_s,
                    "mesh_shape": list(r.mesh_shape),
                    "microbatches": r.plan.microbatches,
                    "ici_n_active": r.ici_n_active,
                    "iterations": r.iterations,
                    "hops": r.hops,
                    "comm_s_by_kind": r.comm_s_by_kind,
                    "decision": dataclasses.asdict(r.decision)
                    if r.decision is not None else None,
                }
            for n_nodes in self.node_counts:
                if not self.cells(name, n_nodes):
                    continue
                b = self.best(name, n_nodes)
                best_plan[str(n_nodes)] = b.plan.label
                scaling[str(n_nodes)] = {
                    "plan": b.plan.label,
                    "t_step_us": b.t_step_s * 1e6,
                    "parallel_efficiency": b.parallel_efficiency,
                    "tokens_per_s": b.tokens_per_s,
                }
            models[name] = {"plans": plans, "best_plan": best_plan,
                            "scaling": scaling}
        return {
            "schema": 1,
            "hw": self.hw,
            "topology": self.topology,
            "cluster": self.cluster,
            "n_cores": self.n_cores,
            "compute_dtype": self.compute_dtype,
            "node_counts": list(self.node_counts),
            "models": models,
            "rank": {str(n): self.rank_table(n)
                     for n in self.node_counts
                     if any(self.cells(m, n) for m in self.results)},
            "kendall_tau": {m: self.plan_rank_stability(m)
                            for m in self.results},
            "wall_s": self.wall_s,
        }


def run_cluster(models: Sequence[str] = DEFAULT_CLUSTER_MODELS,
                node_counts: Sequence[int] = DEFAULT_NODE_COUNTS,
                hw: HardwareSpec = A64FX_CORE,
                n_cores: int = 48,
                topology: Optional[NodeTopology] = None,
                compute_dtype: str = "f32",
                param_dtype: str = "float32",
                phase: str = "train",
                hlo_cache_dir: Optional[Path] = None,
                microbatches: int = 8,
                max_tp: int = 16, max_pp: int = 16,
                cluster_factory=ClusterTopology.tofu_d,
                progress=None) -> ClusterReport:
    """Trace + sweep + rank the cluster scaling study end to end
    (DESIGN.md §20): each model's train step through
    :func:`~.cluster.cluster_sweep` over the node-count axis, shard
    axes resolved by the real MeshRules table.  Returns a
    :class:`ClusterReport`; ``benchmarks/cluster_scaling.py`` wraps
    this with a wall-clock budget and writes ``BENCH_cluster.json``.
    """
    t0 = time.perf_counter()
    topo = topology or hw.topology
    report = ClusterReport(
        hw=hw.name, topology=(topo.name if topo else "degenerate"),
        cluster=cluster_factory(max(node_counts)).name.rsplit("_", 1)[0],
        n_cores=n_cores, compute_dtype=compute_dtype,
        node_counts=tuple(node_counts))
    for m in models:
        if m not in ARCHS:
            raise ValueError(f"unknown arch {m!r}; known: {sorted(ARCHS)}")
        w = cluster_workload(m, phase, param_dtype=param_dtype,
                             hlo_cache_dir=hlo_cache_dir)
        report.results[m] = cluster_sweep(
            w, node_counts, hw=hw, n_cores=n_cores, topology=topo,
            compute_dtype=compute_dtype,
            resolver=mesh_rules_resolver(m), microbatches=microbatches,
            max_tp=max_tp, max_pp=max_pp,
            cluster_factory=cluster_factory,
            progress=(lambda msg: progress(m, msg)) if progress else None)
    report.wall_s = time.perf_counter() - t0
    return report
