"""Serving-at-scale simulator: continuous batching over the node engine.

A copy of ``repro.core.serving``, held bit for bit against it: the loop
is deterministic host code, and every float operation keeps the
reference's order.  One change: :func:`build_zoo_cost_model` prices its
cells through the port's ``zoo.serving_cell_cost`` (ATen captures of the
reduced model) and takes bytes per token from the port's
``serve/kvcache.kv_token_bytes`` on the FULL config's spec tree (building
an ``LM`` allocates no weights).

The paper estimates *application* execution on unbuilt hardware well
enough for relative evaluation; the ROADMAP's millions-of-users target
needs that same machinery for the inference-serving regime.  This module
is a discrete-event serving simulator layered on the existing stack
(DESIGN.md §21):

* **Arrivals** — open-loop Poisson (:func:`poisson_requests`, per-model
  lognormal prompt/output length distributions from :data:`ZOO_TRAFFIC`)
  or a trace file (:func:`requests_from_trace` /
  :func:`load_trace_jsonl`).
* **Iteration costs** — a :class:`CostModel` prices each scheduler
  iteration.  :class:`ZooCostModel` (built by
  :func:`build_zoo_cost_model`) pulls per-phase node estimates from
  ``zoo.serving_cell_cost`` — the reduced trace through the contention-
  aware node engine, disk-cached per (arch, phase, batch) cell with the
  phase in the cache key — and scales them by the full/reduced layer
  ratio.  :class:`SyntheticCostModel` is the closed-form stand-in the
  test harness and the CI smoke drive.
* **KV residency** — per-request cache bytes come from the affine
  decomposition of ``serve/kvcache.cache_bytes``
  (``kv_token_bytes``: bytes/token + bytes/request, exact for every
  cache family including O(1) SSM state), and each decode step pays
  ``memory.stream_time`` for its batch's working set over a node-level
  hierarchy (:func:`node_kv_levels`): a batch that spills L2 streams
  from HBM2 — the KV-residency knee the throughput sweep exposes.
* **Scheduler** — iteration-level continuous batching
  (:func:`simulate_serving`) with :class:`ServingKnobs`: max batch,
  chunked prefill (0 = a prefill monopolizes the iteration and decode
  stalls), FCFS vs shortest-prompt admission, and a paged-KV policy
  (``reject`` reserves the full projected footprint at admission;
  ``evict-oldest``/``evict-newest`` admit optimistically and preempt a
  victim back to the queue — re-prefilling its prompt *plus* tokens
  generated so far — when decode growth overflows the pool).

``tests/test_torch_serving.py`` holds the loop's ``metrics()`` against the
reference's on identical requests and cost models;
``tools/serving_sweep_torch.py`` emits ``BENCH_serving_torch.json``
(schema: DESIGN.md §16) with TTFT/TPOT percentiles and tokens/s/node
Pareto fronts across batching policies.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .hwspec import A64FX_CMG, A64FX_NODE, HardwareSpec, NodeTopology
from .memory import MemLevel, stream_time

#: Decode-batch grid the zoo cost model traces (interpolated between).
DECODE_BATCH_GRID: Tuple[int, ...] = (1, 4, 16, 64)

#: Anti-thrash valve: a request evicted this many times is rejected
#: instead of re-queued (bounds the evict policies' worst case; see
#: :func:`simulate_serving`).
MAX_EVICTIONS_PER_REQUEST = 8


# ------------------------------------------------------------------ arrivals
@dataclass(frozen=True)
class LengthDist:
    """Lognormal prompt/output token-length distribution for one model.

    ``*_cv`` is the coefficient of variation (sigma/mean of the lognormal
    itself); ``cv <= 0`` degenerates to the constant ``round(mean)`` —
    the deterministic-service shape the M/D/1 differential test needs.
    Samples are clipped to ``[1, max_*]``.
    """
    prompt_mean: float
    prompt_cv: float
    out_mean: float
    out_cv: float
    max_prompt: int = 16_384
    max_out: int = 4_096

    @staticmethod
    def _sample(rng, n: int, mean: float, cv: float, hi: int):
        import numpy as np
        if cv <= 0:
            return np.full(n, max(1, round(mean)), dtype=np.int64)
        sigma2 = math.log(1.0 + cv * cv)
        mu = math.log(mean) - sigma2 / 2.0
        xs = rng.lognormal(mu, math.sqrt(sigma2), size=n)
        return np.clip(np.rint(xs).astype(np.int64), 1, hi)

    def sample(self, rng, n: int):
        """(prompt_lengths, out_lengths) as two int arrays of size n."""
        p = self._sample(rng, n, self.prompt_mean, self.prompt_cv,
                         self.max_prompt)
        o = self._sample(rng, n, self.out_mean, self.out_cv, self.max_out)
        return p, o


#: Per-model serving traffic: chat-style short contexts for the small
#: dense models, longer retrieval-style prompts for the big ones, long-
#: context summarization for the sub-quadratic SSM.  Anything not listed
#: falls back to :data:`DEFAULT_TRAFFIC` via :func:`traffic_for`.
ZOO_TRAFFIC: Dict[str, LengthDist] = {
    "chatglm3-6b": LengthDist(256, 0.8, 128, 0.6),
    "qwen1.5-32b": LengthDist(1024, 0.8, 256, 0.6),
    "llama4-scout-17b-a16e": LengthDist(2048, 1.0, 256, 0.6),
    "mamba2-1.3b": LengthDist(4096, 1.0, 128, 0.6),
    "grok-1-314b": LengthDist(1024, 1.0, 256, 0.6),
    "nemotron-4-340b": LengthDist(1024, 1.0, 256, 0.6),
}

DEFAULT_TRAFFIC = LengthDist(512, 0.8, 128, 0.6)


def traffic_for(arch: str) -> LengthDist:
    """The length distribution for ``arch`` (registry fallback)."""
    return ZOO_TRAFFIC.get(arch, DEFAULT_TRAFFIC)


@dataclass(frozen=True)
class RequestSpec:
    """One serving request: arrival time + prompt/output token counts."""
    rid: int
    t_arrival: float
    prompt_tokens: int
    out_tokens: int


def poisson_requests(n: int, rate: float, lengths: LengthDist,
                     seed: int = 0) -> List[RequestSpec]:
    """``n`` open-loop Poisson arrivals at ``rate`` requests/s with
    lengths drawn from ``lengths`` — fixed-``seed`` deterministic (the
    suite pins bit-equality across calls)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.exponential(1.0 / rate, size=n))
    ps, os_ = lengths.sample(rng, n)
    return [RequestSpec(i, float(ts[i]), int(ps[i]), int(os_[i]))
            for i in range(n)]


def requests_from_trace(rows: Iterable[dict]) -> List[RequestSpec]:
    """Build requests from trace rows: mappings with ``t_arrival``,
    ``prompt_tokens``, ``out_tokens`` (``rid`` defaults to row order)."""
    out = []
    for i, r in enumerate(rows):
        out.append(RequestSpec(
            rid=int(r.get("rid", i)),
            t_arrival=float(r["t_arrival"]),
            prompt_tokens=int(r["prompt_tokens"]),
            out_tokens=int(r["out_tokens"])))
    return out


def load_trace_jsonl(path: Path) -> List[RequestSpec]:
    """Read a request trace from a JSONL file (one row per line)."""
    import json
    rows = [json.loads(line) for line in
            Path(path).read_text().splitlines() if line.strip()]
    return requests_from_trace(rows)


# ---------------------------------------------------------------- cost models
def node_kv_levels(hw: HardwareSpec = A64FX_CMG,
                   topology: NodeTopology = A64FX_NODE
                   ) -> Tuple[MemLevel, ...]:
    """Node-aggregate hierarchy for KV-cache streaming: every shared
    level of ``hw.mem_levels`` (those with a ``topology`` aggregate-
    bandwidth entry) scaled to the whole node — for the A64FX, 4 CMGs
    give a 32 MiB L2 at 3.6 TB/s over a 32 GiB HBM2 at 1.024 TB/s.
    Core-private levels (L1D) are skipped: a KV working set never
    persists there across decode steps."""
    out = []
    for lv in hw.mem_levels:
        if lv.name not in topology.shared_read_bw:
            continue
        out.append(MemLevel(
            lv.name, lv.capacity * topology.n_cmgs,
            topology.shared_read_bw[lv.name] * topology.n_cmgs,
            topology.shared_write_bw.get(
                lv.name, topology.shared_read_bw[lv.name])
            * topology.n_cmgs,
            lv.latency_s))
    if not out:
        raise ValueError("no shared levels in hw/topology pair")
    return tuple(out)


@dataclass
class CostModel:
    """Base iteration-cost model for :func:`simulate_serving`.

    Subclasses supply ``prefill_time`` (seconds to process N prompt
    tokens) and ``decode_compute_time`` (seconds for one decode step over
    a batch).  The base class owns the KV accounting: ``kv_bytes`` is the
    affine footprint of a request set, and ``decode_step_time`` is the
    max of compute and streaming the step's KV working set through
    ``levels`` (``memory.stream_time`` — the residency model that makes
    HBM-spilling batches pay real bandwidth).  ``kv_capacity`` bounds the
    paged-KV pool the scheduler allocates from.
    """
    bytes_per_token: float = 0.0
    bytes_per_request: float = 0.0
    levels: Tuple[MemLevel, ...] = ()
    kv_capacity: float = math.inf

    def __post_init__(self):
        if not self.levels:
            self.levels = node_kv_levels()

    def prefill_time(self, tokens: int) -> float:
        """Seconds to prefill ``tokens`` prompt tokens."""
        raise NotImplementedError

    def decode_compute_time(self, batch: int) -> float:
        """Compute seconds for one decode step over ``batch`` sequences."""
        raise NotImplementedError

    def kv_bytes(self, n_requests: int, total_tokens: int) -> float:
        """KV footprint of ``n_requests`` holding ``total_tokens``."""
        return (n_requests * self.bytes_per_request
                + total_tokens * self.bytes_per_token)

    def decode_step_time(self, batch: int, kv_bytes: float) -> float:
        """One decode step: max(compute, KV streaming at residency bw)."""
        tc = self.decode_compute_time(batch)
        tm = stream_time(self.levels, kv_bytes)
        return tc if tc >= tm else tm


@dataclass
class SyntheticCostModel(CostModel):
    """Closed-form affine cost table — the reference cost model.

    ``prefill_time = prefill_t0 + prefill_per_token * tokens``;
    ``decode_compute_time = decode_t0 + decode_per_seq * batch``.  With
    ``bytes_per_token == 0`` service times are deterministic, which is
    exactly the M/D/1 shape the differential suite compares against.
    """
    prefill_t0: float = 0.0
    prefill_per_token: float = 1e-5
    decode_t0: float = 1e-4
    decode_per_seq: float = 1e-5

    def prefill_time(self, tokens: int) -> float:
        return self.prefill_t0 + self.prefill_per_token * tokens

    def decode_compute_time(self, batch: int) -> float:
        return self.decode_t0 + self.decode_per_seq * batch


@dataclass
class ZooCostModel(CostModel):
    """Iteration costs from the zoo's node-engine estimates.

    ``decode_grid`` holds (batch, seconds) cells from
    ``zoo.serving_cell_cost`` — full-depth seconds (reduced-trace t_est
    x the full/reduced layer ratio) — piecewise-linearly interpolated in
    batch and extrapolated beyond the last cell with its final slope.
    Build with :func:`build_zoo_cost_model`.
    """
    arch: str = ""
    prefill_per_token: float = 0.0
    decode_grid: Tuple[Tuple[int, float], ...] = ((1, 1e-3),)
    layer_scale: int = 1

    def prefill_time(self, tokens: int) -> float:
        return self.prefill_per_token * tokens

    def decode_compute_time(self, batch: int) -> float:
        g = self.decode_grid
        if batch <= g[0][0] or len(g) == 1:
            return g[0][1]
        for (b0, t0), (b1, t1) in zip(g, g[1:]):
            if batch <= b1:
                return t0 + (t1 - t0) * (batch - b0) / (b1 - b0)
        (b0, t0), (b1, t1) = g[-2], g[-1]
        return t1 + (t1 - t0) / (b1 - b0) * (batch - b1)


def build_zoo_cost_model(arch: str, n_cores: int = 48,
                         hw: Optional[HardwareSpec] = None,
                         topology: Optional[NodeTopology] = None,
                         batch_grid: Sequence[int] = DECODE_BATCH_GRID,
                         param_dtype: str = "float32",
                         compute_dtype: str = "f32",
                         hlo_cache_dir: Optional[Path] = None,
                         cost_cache_dir: Optional[Path] = None
                         ) -> ZooCostModel:
    """Price one zoo architecture for serving via the node engine.

    Prefill seconds/token come from the reduced prefill trace at batch 1;
    decode seconds per step are traced at each ``batch_grid`` cell (the
    decode shape with its global batch swept).  Both are scaled by the
    full/reduced layer-count ratio (``zoo.long_trace_repeats``), so
    iteration times are full-depth estimates in reduced-width units —
    and, consistently, KV bytes/token come from the FULL config's real
    cache tree (``kvcache.kv_token_bytes`` against the node HBM pool),
    the same units note as the cluster engine's (DESIGN.md §20).  Every
    (arch, phase, batch) cell is disk-cached with the phase in the key
    (``zoo.serving_cell_cost``).
    """
    import dataclasses as dc

    import torch

    from ..configs import ARCHS
    from ..configs.shapes import ZOO_DECODE, ZOO_PREFILL
    from ..models.lm import build_model
    from ..serve.kvcache import kv_token_bytes
    from . import zoo
    from .hwspec import A64FX_CORE
    hw = hw or A64FX_CORE
    topo = topology or hw.topology or A64FX_NODE
    scale = zoo.long_trace_repeats(arch, "prefill")
    pre_shape = dc.replace(ZOO_PREFILL, name="serve_prefill",
                           global_batch=1)
    t_pre = zoo.serving_cell_cost(
        arch, "prefill", pre_shape, n_cores, hw, topo, compute_dtype,
        param_dtype, hlo_cache_dir, cost_cache_dir) * scale
    grid = []
    for b in batch_grid:
        sh = dc.replace(ZOO_DECODE, name=f"serve_decode_b{b}",
                        global_batch=int(b))
        t = zoo.serving_cell_cost(
            arch, "decode", sh, n_cores, hw, topo, compute_dtype,
            param_dtype, hlo_cache_dir, cost_cache_dir) * scale
        grid.append((int(b), t))
    model = build_model(ARCHS[arch])
    per_tok, per_req = kv_token_bytes(model, torch.bfloat16)
    levels = node_kv_levels(A64FX_CMG, topo)
    return ZooCostModel(
        arch=arch, prefill_per_token=t_pre / pre_shape.seq_len,
        decode_grid=tuple(sorted(grid)), layer_scale=scale,
        bytes_per_token=per_tok, bytes_per_request=per_req,
        levels=levels, kv_capacity=levels[-1].capacity)


# ------------------------------------------------------------------ scheduler
@dataclass(frozen=True)
class ServingKnobs:
    """Scheduler policy knobs — the serving sweep's axes.

    ``max_batch`` caps concurrent slots; ``prefill_chunk`` is the prompt
    tokens one iteration may prefill (0 = whole prompt, decode stalls);
    ``admission`` is ``fcfs`` or ``spf`` (shortest prompt first);
    ``eviction`` is ``reject`` (reserve the full projected KV footprint
    at admission, reject requests that can never fit) or
    ``evict-oldest``/``evict-newest`` (optimistic admission, preempt a
    victim when decode growth overflows the pool).
    """
    max_batch: int = 8
    admission: str = "fcfs"
    prefill_chunk: int = 0
    eviction: str = "reject"

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.admission not in ("fcfs", "spf"):
            raise ValueError(f"unknown admission {self.admission!r}")
        if self.eviction not in ("reject", "evict-oldest", "evict-newest"):
            raise ValueError(f"unknown eviction {self.eviction!r}")
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")

    @property
    def label(self) -> str:
        """Short sweep label, e.g. ``spf_b32_chunk256_evict-oldest``."""
        parts = [self.admission, f"b{self.max_batch}"]
        if self.prefill_chunk:
            parts.append(f"chunk{self.prefill_chunk}")
        if self.eviction != "reject":
            parts.append(self.eviction)
        return "_".join(parts)


@dataclass
class RequestStats:
    """Per-request outcome: admission, first token, completion times."""
    spec: RequestSpec
    t_admit: float = math.inf
    t_first: float = math.inf
    t_done: float = math.inf
    t_reject: float = math.inf
    n_evictions: int = 0

    @property
    def completed(self) -> bool:
        return math.isfinite(self.t_done)

    @property
    def rejected(self) -> bool:
        return math.isfinite(self.t_reject)

    @property
    def ttft(self) -> float:
        """Time to first token (arrival -> first emission)."""
        return self.t_first - self.spec.t_arrival

    @property
    def wait(self) -> float:
        """Queueing delay (arrival -> first admission)."""
        return self.t_admit - self.spec.t_arrival

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first (0 if out == 1)."""
        if self.spec.out_tokens <= 1:
            return 0.0
        return (self.t_done - self.t_first) / (self.spec.out_tokens - 1)

    @property
    def sojourn(self) -> float:
        """Total time in system (arrival -> completion or rejection)."""
        leave = self.t_done if self.completed else self.t_reject
        return leave - self.spec.t_arrival


@dataclass
class _Run:
    """One active slot: prefill progress + generated-token count."""
    idx: int                    # index into the sorted request list
    prefill_target: int         # tokens to prefill (prompt [+ regen])
    done_prompt: int = 0
    generated: int = 0
    admit_seq: int = 0          # monotone admission counter


def percentile(xs: Sequence[float], q: float) -> float:
    """Numpy-style linear-interpolation percentile (``q`` in [0, 100])."""
    s = sorted(xs)
    if not s:
        return math.nan
    k = (len(s) - 1) * q / 100.0
    f = math.floor(k)
    c = min(f + 1, len(s) - 1)
    return s[f] + (s[c] - s[f]) * (k - f)


@dataclass
class ServingResult:
    """One serving run: per-request stats + aggregate counters.

    ``area_in_system`` is the event-loop-integrated ``int N(t) dt``
    (requests in system over time) — accumulated *independently* of the
    per-request timestamps, so the Little's-law identity
    ``area == sum(sojourn)`` is a real bookkeeping invariant, not a
    tautology.  :meth:`metrics` derives the BENCH row.
    """
    knobs: ServingKnobs
    stats: List[RequestStats] = field(default_factory=list)
    t_start: float = 0.0
    t_end: float = 0.0
    n_iterations: int = 0
    n_prefill_iterations: int = 0
    n_decode_iterations: int = 0
    n_evictions: int = 0
    sum_decode_batch: int = 0
    area_in_system: float = 0.0
    max_kv_bytes: float = 0.0

    def done(self) -> List[RequestStats]:
        """Completed requests (the SLO population)."""
        return [st for st in self.stats if st.completed]

    def ttfts(self) -> List[float]:
        return [st.ttft for st in self.done()]

    def tpots(self) -> List[float]:
        return [st.tpot for st in self.done()
                if st.spec.out_tokens > 1]

    @property
    def duration(self) -> float:
        return max(self.t_end - self.t_start, 1e-30)

    @property
    def tokens_out(self) -> int:
        return sum(st.spec.out_tokens for st in self.done())

    @property
    def tokens_per_s(self) -> float:
        """Output tokens per second per node over the whole run."""
        return self.tokens_out / self.duration

    def little_law_gap(self) -> float:
        """Relative gap between the integrated mean number-in-system and
        ``lambda * W`` over the run — ~1e-15 when the loop's bookkeeping
        is exact (every request leaves, so the two sides are the same
        integral accumulated two different ways)."""
        left = [st for st in self.stats
                if st.completed or st.rejected]
        if not left:
            return 0.0
        mean_l = self.area_in_system / self.duration
        lam = len(left) / self.duration
        w = sum(st.sojourn for st in left) / len(left)
        return abs(mean_l - lam * w) / max(mean_l, 1e-30)

    def metrics(self) -> dict:
        """The per-(model, policy) BENCH_serving row (DESIGN.md §16)."""
        ttfts, tpots = self.ttfts(), self.tpots()
        nd = max(self.n_decode_iterations, 1)
        return {
            "completed": len(self.done()),
            "rejected": sum(1 for st in self.stats if st.rejected),
            "n_evictions": self.n_evictions,
            "p50_ttft_ms": percentile(ttfts, 50) * 1e3,
            "p99_ttft_ms": percentile(ttfts, 99) * 1e3,
            "p50_tpot_ms": (percentile(tpots, 50) * 1e3
                            if tpots else 0.0),
            "p99_tpot_ms": (percentile(tpots, 99) * 1e3
                            if tpots else 0.0),
            "mean_wait_ms": (sum(st.wait for st in self.done())
                             / max(len(self.done()), 1) * 1e3),
            "tokens_per_s": self.tokens_per_s,
            "mean_decode_batch": self.sum_decode_batch / nd,
            "mean_in_system": self.area_in_system / self.duration,
            "little_law_gap": self.little_law_gap(),
            "max_kv_gb": self.max_kv_bytes / 2**30,
            "duration_s": self.duration,
        }


def _run_bytes(cost: CostModel, run: _Run) -> float:
    return cost.kv_bytes(1, run.done_prompt + run.generated)


def simulate_serving(requests: Sequence[RequestSpec], cost: CostModel,
                     knobs: ServingKnobs) -> ServingResult:
    """Run the continuous-batching event loop over ``requests``.

    Iteration semantics (the Orca/vLLM-style loop, DESIGN.md §21):

    1. arrivals with ``t_arrival <= t`` join the wait queue; when the
       system is idle, ``t`` jumps to the next arrival;
    2. admission fills slots up to ``max_batch`` per the admission knob,
       with KV accounting per the eviction knob (see
       :class:`ServingKnobs`); requests whose footprint can never fit
       the pool alone are rejected (terminally);
    3. under the evict policies, if actual KV bytes overflow the pool
       the victim (newest/oldest admission) is preempted back to the
       queue front and must re-prefill its prompt plus the tokens it
       already generated (emitted tokens are not re-emitted); a request
       evicted :data:`MAX_EVICTIONS_PER_REQUEST` times is rejected —
       the anti-thrash valve that bounds the loop;
    4. the iteration runs: with an unchunked prefill pending, that one
       prefill monopolizes the iteration (decode stalls — the TTFT/TPOT
       tension the chunk knob trades); with ``prefill_chunk > 0``, up to
       that many prompt tokens prefill while the decode-ready set
       advances one token in the same iteration; otherwise one decode
       step over the ready set, priced by
       :meth:`CostModel.decode_step_time` on the set's KV working set;
    5. a request emits its first token when its prompt completes and one
       token per decode step after; at ``out_tokens`` it completes and
       frees its KV.

    Determinism: the loop is pure over (requests, cost, knobs) — no RNG —
    so fixed-seed arrival generators give bit-identical results, and at
    ``max_batch=1`` with whole-prompt prefill the float-op sequence
    degenerates exactly to the serial reference the differential test
    replays.
    """
    reqs = sorted(requests, key=lambda r: (r.t_arrival, r.rid))
    n = len(reqs)
    res = ServingResult(knobs=knobs,
                        stats=[RequestStats(spec=r) for r in reqs])
    if n == 0:
        return res
    res.t_start = reqs[0].t_arrival
    optimistic = knobs.eviction != "reject"
    queue: List[int] = []       # waiting indices, FCFS order
    active: List[_Run] = []
    i = 0                       # next arrival to ingest
    t = 0.0
    committed = 0.0             # reserved bytes (reject policy)
    admit_seq = 0
    n_left = n                  # not yet completed/rejected

    def projected(k: int) -> float:
        r = reqs[k]
        return cost.kv_bytes(1, r.prompt_tokens + r.out_tokens)

    def optimistic_bytes(k: int) -> float:
        # the scheduler cannot see out_tokens (realistic optimism): it
        # reserves prompt (+ tokens to re-prefill after eviction) + 1
        return cost.kv_bytes(
            1, reqs[k].prompt_tokens + _regen_of(res, k) + 1)

    while n_left > 0:
        if not active and not queue:
            # idle: jump to the next arrival
            if reqs[i].t_arrival > t:
                t = reqs[i].t_arrival
        while i < n and reqs[i].t_arrival <= t:
            queue.append(i)
            i += 1

        # ---------------------------------------------------- admission
        while queue and len(active) < knobs.max_batch:
            if knobs.admission == "spf":
                qi = min(range(len(queue)),
                         key=lambda j: (reqs[queue[j]].prompt_tokens,
                                        queue[j]))
            else:
                qi = 0
            k = queue[qi]
            if optimistic:
                current = sum(_run_bytes(cost, r) for r in active)
                need = optimistic_bytes(k)
            else:
                current = committed
                need = projected(k)
            if current + need > cost.kv_capacity:
                if need > cost.kv_capacity:
                    # can never fit even alone: terminal rejection
                    queue.pop(qi)
                    res.stats[k].t_reject = t
                    n_left -= 1
                    continue
                break           # head-of-line blocks until space frees
            queue.pop(qi)
            st = res.stats[k]
            if st.t_admit > t:
                st.t_admit = t
            target = reqs[k].prompt_tokens + _regen_of(res, k)
            active.append(_Run(idx=k, prefill_target=target,
                               admit_seq=admit_seq))
            admit_seq += 1
            if not optimistic:
                committed += need

        if not active:
            continue            # everything rejected/blocked; loop jumps

        # ----------------------------------------------- eviction pass
        if optimistic and len(active) > 1:
            while len(active) > 1:
                cur = sum(_run_bytes(cost, r) for r in active)
                if cur <= cost.kv_capacity:
                    break
                pick = (max if knobs.eviction == "evict-newest"
                        else min)(active, key=lambda r: r.admit_seq)
                active.remove(pick)
                st = res.stats[pick.idx]
                st.n_evictions += 1
                res.n_evictions += 1
                if st.n_evictions > MAX_EVICTIONS_PER_REQUEST:
                    st.t_reject = t
                    n_left -= 1
                else:
                    _set_regen(res, pick.idx, pick.generated)
                    queue.insert(0, pick.idx)

        # ------------------------------------------- build the iteration
        pending = [r for r in active if r.done_prompt < r.prefill_target]
        ready = [r for r in active
                 if r.done_prompt >= r.prefill_target
                 and r.generated < reqs[r.idx].out_tokens]
        dt = 0.0
        finished_prefill: List[_Run] = []
        decoded: List[_Run] = []
        if pending and knobs.prefill_chunk == 0:
            run = pending[0]
            take = run.prefill_target - run.done_prompt
            run.done_prompt = run.prefill_target
            dt = cost.prefill_time(take)
            finished_prefill.append(run)
            res.n_prefill_iterations += 1
        else:
            taken = 0
            if pending:
                budget = knobs.prefill_chunk
                for run in pending:
                    room = budget - taken
                    if room <= 0:
                        break
                    step = min(room, run.prefill_target - run.done_prompt)
                    run.done_prompt += step
                    taken += step
                    if run.done_prompt >= run.prefill_target:
                        finished_prefill.append(run)
                dt += cost.prefill_time(taken)
                res.n_prefill_iterations += 1
            if ready:
                tokens = 0
                for run in ready:
                    tokens += run.done_prompt + run.generated
                kv = cost.kv_bytes(len(ready), tokens)
                dt += cost.decode_step_time(len(ready), kv)
                decoded = ready
                res.n_decode_iterations += 1
                res.sum_decode_batch += len(ready)

        t_next = t + dt
        res.n_iterations += 1

        # exact N(t) integration: everyone in system over [t, t_next),
        # plus partial spans of arrivals landing inside the iteration
        res.area_in_system += (len(active) + len(queue)) * dt
        j = i
        while j < n and reqs[j].t_arrival <= t_next:
            res.area_in_system += t_next - reqs[j].t_arrival
            j += 1
        t = t_next

        # ------------------------------------------------ apply effects
        for run in finished_prefill:
            st = res.stats[run.idx]
            if run.generated == 0:
                run.generated = 1
                if st.t_first > t:
                    st.t_first = t
        for run in decoded:
            run.generated += 1
        done_now = [r for r in active
                    if r.done_prompt >= r.prefill_target
                    and r.generated >= reqs[r.idx].out_tokens]
        for run in done_now:
            active.remove(run)
            res.stats[run.idx].t_done = t
            n_left -= 1
            if not optimistic:
                committed -= projected(run.idx)
        cur_bytes = sum(_run_bytes(cost, r) for r in active)
        if cur_bytes > res.max_kv_bytes:
            res.max_kv_bytes = cur_bytes

    res.t_end = t
    return res


# regenerated-token bookkeeping for evicted requests: the re-prefill must
# cover prompt + tokens generated before eviction (kept off RequestStats
# so the public stats stay purely observational)
_REGEN_KEY = "_regen_tokens"


def _set_regen(res: ServingResult, idx: int, generated: int) -> None:
    setattr(res.stats[idx], _REGEN_KEY, generated)


def _regen_of(res: ServingResult, idx: int) -> int:
    return getattr(res.stats[idx], _REGEN_KEY, 0)


# -------------------------------------------------------------- pareto front
def pareto_front(points: Sequence[Tuple[float, float]]) -> List[int]:
    """Indices of the non-dominated points, both coordinates minimized
    (the bench reports (p99 TTFT, -tokens/s) fronts per model)."""
    out = []
    for a, pa in enumerate(points):
        dominated = False
        for b, pb in enumerate(points):
            if b != a and pb[0] <= pa[0] and pb[1] <= pa[1] \
                    and (pb[0] < pa[0] or pb[1] < pa[1]):
                dominated = True
                break
        if not dominated:
            out.append(a)
    return out
