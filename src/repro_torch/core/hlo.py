"""Post-SPMD HLO text parser -> per-op cost records.

A copy of ``repro.core.hlo`` (no JAX; the port's tests hold it bit for bit
against the reference), plus ``Program.exact_dtypes``, which only the ATen
frontend (``core.aten``) sets.

The simulator consumes ``compiled.as_text()`` — the *partitioned* module, so
every shape is per-device and every inter-device transfer is an explicit
collective op.  This is the gem5-"binary" of our world.

Why parse ourselves instead of trusting ``cost_analysis()``:
* XLA's HloCostAnalysis visits each computation ONCE — a ``lax.scan`` over 96
  layers is a ``while`` whose body is counted a single time.  We extract while
  trip counts (from the loop-condition's integer constants) and multiply.
* cost_analysis has no per-op / per-class breakdown and no collective bytes.
* Fusions are costed at their *boundary* bytes (operands + outputs), modeling
  VMEM-resident intermediates — the cache-hierarchy insight of the paper.

Everything here is pure-python string processing; no jax dependency.
"""
from __future__ import annotations

import math
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional, Tuple

DTYPE_BYTES = {
    "pred": 1, "s4": 0.5, "u4": 0.5, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

COLLECTIVES = {
    "all-reduce": "all-reduce", "all-reduce-start": "all-reduce",
    "all-gather": "all-gather", "all-gather-start": "all-gather",
    "reduce-scatter": "reduce-scatter",
    "all-to-all": "all-to-all", "ragged-all-to-all": "all-to-all",
    "collective-permute": "collective-permute",
    "collective-permute-start": "collective-permute",
    "collective-broadcast": "all-gather",
}

TRANSCENDENTAL = {
    "exponential", "exponential-minus-one", "log", "log-plus-one", "tanh",
    "sine", "cosine", "tan", "atan2", "power", "sqrt", "rsqrt", "cbrt",
    "logistic", "erf", "erf-inv", "divide", "remainder",
}

ELEMENTWISE = {
    "add", "subtract", "multiply", "maximum", "minimum", "and", "or", "xor",
    "not", "negate", "abs", "compare", "select", "clamp", "convert", "floor",
    "ceil", "round-nearest-afz", "round-nearest-even", "sign",
    "shift-left", "shift-right-arithmetic", "shift-right-logical", "iota",
    "broadcast", "map", "is-finite", "popcnt", "clz", "stochastic-convert",
    "real", "imag", "complex",
}

REDUCE = {"reduce", "reduce-window", "select-and-scatter"}

DATA_MOVEMENT = {
    "gather", "scatter", "dynamic-slice", "dynamic-update-slice", "sort",
    "transpose", "reshape", "copy", "concatenate", "pad", "slice", "reverse",
    "rng", "rng-bit-generator", "rng-get-and-update-state", "copy-start",
    "cholesky", "triangular-solve", "fft", "custom-call",
}

FREE = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "partition-id", "replica-id", "domain", "opt-barrier",
    "copy-done", "all-reduce-done", "all-gather-done",
    "collective-permute-done", "async-done", "async-update", "bitcast-convert",
    "get-dimension-size", "add-dependency", "send", "send-done", "recv",
    "recv-done",
}


@dataclass
class Instr:
    """One parsed HLO instruction (pre-aggregation; see OpStat)."""
    name: str
    dtype: str
    shape: Tuple[int, ...]
    out_bytes: float
    opcode: str
    operands: List[str]
    attrs: str
    is_tuple: bool = False
    tuple_bytes: float = 0.0


@dataclass
class Computation:
    """One HLO computation: params + instructions, fusion bodies included."""
    name: str
    params: Dict[str, Tuple[str, Tuple[int, ...]]]
    instrs: Dict[str, Instr]
    order: List[str]
    is_entry: bool = False


@dataclass
class OpStat:
    """One costed HLO op (already multiplied by enclosing loop trips)."""
    name: str
    opcode: str
    opclass: str                 # matmul | elementwise | transcendental |
                                 # reduce | data | collective | free
    dtype: str
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes_accessed: float = 0.0  # boundary bytes: read_bytes + write_bytes
    read_bytes: float = 0.0      # boundary bytes loaded (operand streams)
    write_bytes: float = 0.0     # boundary bytes stored (outputs); the
                                 # memory model routes reads and writes
                                 # separately (asymmetric load/store paths)
    comm_bytes: float = 0.0      # collective payload bytes (per device)
    group_size: int = 1
    count: float = 1.0
    dot_dims: Optional[Tuple[int, int, int]] = None   # (M, N, K) for padding waste
    # transcendental element counts by HLO opcode (survives fusion), so the
    # engine can apply the paper-style per-opcode latency table
    trans_by_opcode: Dict[str, float] = field(default_factory=dict)
    # plain-elementwise element counts by HLO opcode (survives fusion):
    # lets `opcode_factor` distinguish e.g. minimum/round/convert from a
    # 1-flop add — the per-OpClass VPU latency table for non-
    # transcendental opcodes (DESIGN.md §14 satellite)
    vpu_by_opcode: Dict[str, float] = field(default_factory=dict)
    # def-use edges: indices into Program.ops of the producers this op
    # consumes (resolved through free/pass-through ops and computation
    # boundaries).  The schedule engine turns these into issue constraints;
    # the occupancy engine ignores them.
    deps: List[int] = field(default_factory=list)
    # bytes consumed along each dep edge (aligned with ``deps``): operand
    # sizes, split evenly when one operand resolves to several producers.
    # core.memory turns these into reuse-distance-routed reads.
    dep_bytes: List[float] = field(default_factory=list)


@dataclass
class Program:
    """The parsed program: entry-computation op stats, fusion-inlined.

    This is every engine's input artifact; compiled/node/costed forms
    are memoized on it (DESIGN.md §2-§3).
    """
    ops: List[OpStat]
    entry: str
    n_partitions: int
    # True when every op's dtype is the one the device computes in, as in
    # an ATen graph (``core.aten.parse_graph`` sets it on its programs);
    # False for XLA:CPU HLO, whose f32 ops the cost model de-normalizes to
    # ``compute_dtype`` (DESIGN.md §7).  Not a dataclass field, so parsed
    # HLO programs stay equal to the reference's.
    exact_dtypes: ClassVar[bool] = False

    def denorm_dtype(self, compute_dtype: Optional[str]) -> Optional[str]:
        """The ``compute_dtype`` that the §7 de-normalization sees: None
        for a program with exact dtypes, so its f32 ops cost at f32."""
        return None if self.exact_dtypes else compute_dtype

    # ---- aggregates
    def total(self, attr: str) -> float:
        return sum(getattr(o, attr) * o.count for o in self.ops)

    @property
    def flops(self) -> float:
        return self.total("flops")

    @property
    def bytes_accessed(self) -> float:
        return self.total("bytes_accessed")

    @property
    def comm_bytes(self) -> float:
        return self.total("comm_bytes")

    def bytes_normalized(self, compute_dtype: str) -> float:
        """Bytes with XLA:CPU float-normalization inverted: f32 ops count at
        16-bit width when the model computes in bf16/f16 (see engine);
        exact dtypes are not de-normalized."""
        if self.denorm_dtype(compute_dtype) not in ("bf16", "f16"):
            return self.bytes_accessed
        return sum((0.5 if o.dtype == "f32" else 1.0)
                   * o.bytes_accessed * o.count for o in self.ops)

    def comm_normalized(self, compute_dtype: str) -> float:
        if self.denorm_dtype(compute_dtype) not in ("bf16", "f16"):
            return self.comm_bytes
        return sum((0.5 if o.dtype == "f32" else 1.0)
                   * o.comm_bytes * o.count for o in self.ops)

    def by_class(self) -> Dict[str, Dict[str, float]]:
        agg: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"flops": 0.0, "bytes": 0.0, "comm": 0.0, "n": 0.0,
                     "transcendentals": 0.0})
        for o in self.ops:
            a = agg[o.opclass]
            a["flops"] += o.flops * o.count
            a["bytes"] += o.bytes_accessed * o.count
            a["comm"] += o.comm_bytes * o.count
            a["transcendentals"] += o.transcendentals * o.count
            a["n"] += o.count
        return dict(agg)

    def comm_by_collective(self) -> Dict[str, float]:
        agg: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            if o.opclass == "collective":
                agg[o.opcode] += o.comm_bytes * o.count
        return dict(agg)

    def matmul_utilization(self, tile=(128, 128, 128)) -> float:
        """Useful-lane accounting (paper's predicate-aware SIMD counting):
        fraction of MXU-tile-padded matmul FLOPs that are useful."""
        useful, padded = 0.0, 0.0
        for o in self.ops:
            if o.opclass != "matmul" or not o.dot_dims:
                continue
            m, n, k = o.dot_dims
            batch = (o.flops / max(2 * m * n * k, 1))
            pm = math.ceil(m / tile[0]) * tile[0]
            pk = math.ceil(k / tile[1]) * tile[1]
            pn = math.ceil(n / tile[2]) * tile[2]
            useful += o.flops * o.count
            padded += 2.0 * pm * pk * pn * batch * o.count
        return useful / padded if padded else 1.0


# ------------------------------------------------------------------ parsing
_TYPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_GROUPS_ITOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_CONST_INT_RE = re.compile(r"s(?:32|64)\[\]\s+constant\((\d+)\)")
_NPART_RE = re.compile(r"num_partitions=(\d+)")


def _parse_type(s: str) -> Tuple[str, Tuple[int, ...], float, bool, float]:
    """Returns (dtype, shape, bytes, is_tuple, tuple_bytes)."""
    s = s.strip()
    if s.startswith("("):
        total = 0.0
        first = None
        for m in _TYPE_RE.finditer(s):
            dt, dims = m.group(1), m.group(2)
            if dt not in DTYPE_BYTES:
                continue
            shape = tuple(int(x) for x in dims.split(",") if x)
            b = DTYPE_BYTES[dt] * max(1, math.prod(shape)) if dt != "token" else 0
            total += b
            if first is None:
                first = (dt, shape, b)
        if first is None:
            return "f32", (), 0.0, True, 0.0
        return first[0], first[1], first[2], True, total
    m = _TYPE_RE.match(s)
    if not m:
        return "f32", (), 0.0, False, 0.0
    dt, dims = m.group(1), m.group(2)
    shape = tuple(int(x) for x in dims.split(",") if x)
    nbytes = DTYPE_BYTES.get(dt, 4) * max(1, math.prod(shape))
    if dt == "token":
        nbytes = 0
    return dt, shape, nbytes, False, nbytes


def _split_top_level(s: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return [x for x in out if x]


def _parse_rhs(rhs: str):
    """rhs like: 'f32[8,256]{1,0} dot(%a, %b), lhs_contracting_dims={1}, ...'
    Returns (type_str, opcode, operand_names, attrs)."""
    rhs = rhs.strip()
    if rhs.startswith("("):
        depth = 0
        for i, ch in enumerate(rhs):
            depth += ch == "("
            depth -= ch == ")"
            if depth == 0:
                break
        type_str = rhs[: i + 1]
        rest = rhs[i + 1:].strip()
    else:
        sp = rhs.index(" ")
        type_str = rhs[:sp]
        rest = rhs[sp + 1:].strip()
    m = re.match(r"([\w\-]+)\(", rest)
    if not m:
        return type_str, rest.split("(")[0], [], ""
    opcode = m.group(1)
    depth = 0
    start = m.end() - 1
    for i in range(start, len(rest)):
        depth += rest[i] == "("
        depth -= rest[i] == ")"
        if depth == 0:
            break
    args = rest[start + 1: i]
    attrs = rest[i + 1:]
    operands = []
    for a in _split_top_level(args):
        # strip /*index=N*/ positional comments (emitted for >5 operands) —
        # losing an operand here shifts every later parameter index.
        a = re.sub(r"/\*.*?\*/", "", a).strip()
        # compiled modules annotate operands with their full (layout-bearing)
        # type: ``copy(f32[32,32]{1,0:T(8,128)} %Arg_0.1)``.  The name is the
        # %-sigiled token; fall back to the last whitespace token for sigil-
        # free dumps (and bare constant literals like ``constant(0)``).
        toks = re.findall(r"%([\w.\-]+)", a)
        if toks:
            operands.append(toks[-1])
            continue
        parts = a.split()
        am = re.match(r"%?([\w.\-]+)", parts[-1] if parts else a)
        if am:
            operands.append(am.group(1))
    return type_str, opcode, operands, attrs


def parse_computations(text: str) -> Tuple[Dict[str, Computation], str, int]:
    comps: Dict[str, Computation] = {}
    entry_name = ""
    npart = 1
    m = _NPART_RE.search(text)
    if m:
        npart = int(m.group(1))

    cur: Optional[Computation] = None
    for raw in text.splitlines():
        line = raw.rstrip()
        stripped = line.strip()
        if cur is None:
            hm = re.match(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->\s*(.*?)\s*\{",
                          stripped)
            if hm and ("=" not in stripped.split("(")[0]):
                is_entry = bool(hm.group(1))
                name = hm.group(2)
                params: Dict[str, Tuple[str, Tuple[int, ...]]] = {}
                for pdef in _split_top_level(hm.group(3)):
                    pm = re.match(r"([\w.\-]+)\s*:\s*(.*)", pdef)
                    if pm:
                        dt, shape, b, _, _ = _parse_type(pm.group(2))
                        params[pm.group(1)] = (dt, shape)
                cur = Computation(name, params, {}, [], is_entry)
                if is_entry:
                    entry_name = name
            continue
        if stripped == "}":
            comps[cur.name] = cur
            cur = None
            continue
        im = _INSTR_RE.match(stripped)
        if not im or "=" not in stripped:
            continue
        name, rhs = im.group(1), im.group(2)
        try:
            type_str, opcode, operands, attrs = _parse_rhs(rhs)
        except (ValueError, IndexError):
            continue
        dt, shape, nbytes, is_tuple, tbytes = _parse_type(type_str)
        cur.instrs[name] = Instr(name, dt, shape, nbytes, opcode, operands,
                                 attrs, is_tuple, tbytes)
        cur.order.append(name)
    return comps, entry_name, npart


# ------------------------------------------------------------------ costing
def _single_operand_bytes(name: str, comp: Computation) -> float:
    if name in comp.instrs:
        o = comp.instrs[name]
        return o.tuple_bytes if o.is_tuple else o.out_bytes
    if name in comp.params:
        dt, shape = comp.params[name]
        return DTYPE_BYTES.get(dt, 4) * max(1, math.prod(shape))
    return 0.0


def _operand_bytes(instr: Instr, comp: Computation) -> float:
    return sum(_single_operand_bytes(op, comp) for op in instr.operands)


_PASSTHROUGH = {"convert", "bitcast", "copy", "reshape", "bitcast-convert"}


def _chain_source(comp: Computation, name: str) -> str:
    """Follow convert/bitcast/copy/reshape chains to the producing op."""
    seen = set()
    while name in comp.instrs and name not in seen:
        seen.add(name)
        instr = comp.instrs[name]
        if instr.opcode in _PASSTHROUGH and instr.operands:
            name = instr.operands[0]
        else:
            break
    return name


def _fusion_boundary_bytes(instr: Instr, comp: Computation,
                           callee: Optional[Computation]
                           ) -> Tuple[float, float]:
    """Boundary (read, write) bytes a fusion actually moves — the
    cache-hierarchy insight:

    * a fusion parameter consumed ONLY by (dynamic-)slice/gather ops reads
      just the sliced region, not the buffer (lax.scan slices the stacked
      layer weights / caches per iteration),
    * a fusion whose root is a dynamic-update-slice of a parameter updates
      IN PLACE (XLA aliases loop carries): the write costs the update
      region, and the aliased parameter is not streamed at all.

    Without these two rules every scan iteration appears to re-read and
    re-write entire stacked buffers (measured 26x overcount on the decode
    KV cache; see EXPERIMENTS.md §Perf).
    """
    out_full = instr.tuple_bytes if instr.is_tuple else instr.out_bytes
    if callee is None:
        return _operand_bytes(instr, comp), out_full

    # callee parameter name -> fusion operand name (by parameter index)
    param_of: Dict[str, str] = {}
    for nm, ci in callee.instrs.items():
        if ci.opcode == "parameter" and ci.operands:
            try:
                idx = int(ci.operands[0])
            except ValueError:
                continue
            if idx < len(instr.operands):
                param_of[nm] = instr.operands[idx]

    # in-place DUS detection on the root chain
    root_name = callee.order[-1] if callee.order else ""
    aliased_param: Optional[str] = None
    read_eff, write_eff = 0.0, out_full
    dus = callee.instrs.get(_chain_source(callee, root_name))
    if dus is not None and dus.opcode == "dynamic-update-slice":
        target = _chain_source(callee, dus.operands[0])
        tgt = callee.instrs.get(target)
        upd_bytes = _single_operand_bytes(
            dus.operands[1] if len(dus.operands) > 1 else "", callee)
        if tgt is not None and tgt.opcode == "parameter":
            aliased_param = target
            # read + write the update region, in place
            read_eff, write_eff = upd_bytes, upd_bytes
        # DUS of a freshly-sliced buffer (slice -> update -> emit): the
        # emit is real, but only slice-sized — out_full is already that.

    total = 0.0
    for pname, _ in param_of.items():
        if pname == aliased_param:
            continue
        uses = [ci for ci in callee.instrs.values()
                if pname in ci.operands and ci.opcode != "parameter"]
        if uses and all(u.opcode in ("dynamic-slice", "slice", "gather")
                        for u in uses):
            total += sum(u.out_bytes for u in uses)
        else:
            total += _single_operand_bytes(param_of[pname], comp)
    return total + read_eff, write_eff


def _dot_cost(instr: Instr, comp: Computation):
    """Returns (flops, (M, N, K))."""
    out_elems = max(1, math.prod(instr.shape))
    lhs = instr.operands[0] if instr.operands else None
    lhs_shape: Tuple[int, ...] = ()
    if lhs in comp.instrs:
        lhs_shape = comp.instrs[lhs].shape
    elif lhs in comp.params:
        lhs_shape = comp.params[lhs][1]
    cm = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", instr.attrs)
    bm = re.search(r"lhs_batch_dims=\{([\d,]*)\}", instr.attrs)
    cdims = [int(x) for x in cm.group(1).split(",") if x] if cm else []
    bdims = [int(x) for x in bm.group(1).split(",") if x] if bm else []
    K = 1
    for d in cdims:
        if d < len(lhs_shape):
            K *= lhs_shape[d]
    batch = 1
    for d in bdims:
        if d < len(lhs_shape):
            batch *= lhs_shape[d]
    M = 1
    for i, d in enumerate(lhs_shape):
        if i not in cdims and i not in bdims:
            M *= d
    N = out_elems // max(M * batch, 1)
    flops = 2.0 * out_elems * K
    return flops, (M, N, K)


def _conv_cost(instr: Instr, comp: Computation) -> float:
    out_elems = max(1, math.prod(instr.shape))
    rhs = instr.operands[1] if len(instr.operands) > 1 else None
    k_elems = 1
    if rhs in comp.instrs:
        k_elems = max(1, math.prod(comp.instrs[rhs].shape))
    elif rhs in comp.params:
        k_elems = max(1, math.prod(comp.params[rhs][1]))
    # flops ~= 2 * out * (kernel elems / out_channels)
    out_ch = instr.shape[-1] if instr.shape else 1
    return 2.0 * out_elems * max(1, k_elems // max(out_ch, 1))


def _group_size(attrs: str, npart: int) -> int:
    m = _GROUPS_ITOTA_RE.search(attrs)
    if m:
        return max(1, int(m.group(2)))
    m = _GROUPS_LIST_RE.search(attrs)
    if m:
        return max(1, len([x for x in m.group(1).split(",") if x.strip()]))
    return npart


def _while_trip_count(cond: Computation, comps: Dict[str, Computation]) -> int:
    """Heuristic: largest integer constant in the condition computation
    (transitively through fusions).  XLA loop conditions compare the
    induction variable against the trip-count constant."""
    best = 1
    text_consts = []
    for instr in cond.instrs.values():
        if instr.opcode == "constant" and not instr.shape and \
                instr.dtype in ("s32", "s64", "u32", "u64"):
            # the constant literal was captured into operands by _parse_rhs
            for op in instr.operands:
                if op.isdigit():
                    text_consts.append(int(op))
        callee = _called(instr.attrs)
        if callee and callee in comps:
            for i2 in comps[callee].instrs.values():
                if i2.opcode == "constant" and not i2.shape and \
                        i2.dtype in ("s32", "s64", "u32", "u64"):
                    for op in i2.operands:
                        if op.isdigit():
                            text_consts.append(int(op))
    if text_consts:
        best = max(best, max(text_consts))
    return best


def _called(attrs: str) -> Optional[str]:
    m = re.search(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)", attrs)
    return m.group(1) if m else None


def _classify(opcode: str) -> str:
    if opcode in ("dot", "convolution"):
        return "matmul"
    if opcode in COLLECTIVES:
        return "collective"
    if opcode in TRANSCENDENTAL:
        return "transcendental"
    if opcode in ELEMENTWISE:
        return "elementwise"
    if opcode in REDUCE:
        return "reduce"
    if opcode in DATA_MOVEMENT:
        return "data"
    if opcode in FREE or opcode.endswith("-done"):
        return "free"
    return "elementwise"


def _consumers(comp: Computation) -> Dict[str, List[str]]:
    cons: Dict[str, List[str]] = defaultdict(list)
    for nm, instr in comp.instrs.items():
        for op in instr.operands:
            cons[op].append(nm)
    return cons


def _group_sinks(out: List[OpStat], start: int) -> List[int]:
    """Indices in out[start:] not consumed by another op of the same group —
    the group's dataflow outputs (what a downstream consumer waits on)."""
    group = range(start, len(out))
    if not group:
        return []
    referenced = set()
    for i in group:
        referenced.update(d for d in out[i].deps if d >= start)
    sinks = [i for i in group if i not in referenced]
    return sinks or list(group)


def _callee_param_deps(callee: Computation,
                       operand_deps: List[List[int]]) -> Dict[str, List[int]]:
    """Map callee parameter instr names to the call-site operands' producer
    indices (positionally, via the parameter(N) index)."""
    pd: Dict[str, List[int]] = {}
    for nm, ci in callee.instrs.items():
        if ci.opcode == "parameter" and ci.operands:
            try:
                k = int(ci.operands[0])
            except ValueError:
                continue
            if k < len(operand_deps):
                pd[nm] = operand_deps[k]
    return pd


def _cost_computation(comp: Computation, comps: Dict[str, Computation],
                      npart: int, mult: float, out: List[OpStat],
                      inline_fusions: bool,
                      param_deps: Optional[Dict[str, List[int]]] = None):
    consumers = _consumers(comp)
    param_deps = param_deps or {}
    # instr name -> indices into ``out`` that produce it (def-use edges)
    producer: Dict[str, List[int]] = {}
    resolved: Dict[str, List[int]] = {}

    def _resolve(nm: str) -> List[int]:
        if nm in producer:
            return producer[nm]
        if nm in resolved:
            return resolved[nm]
        if nm in param_deps:
            resolved[nm] = param_deps[nm]
            return resolved[nm]
        got: List[int] = []
        ci = comp.instrs.get(nm)
        if ci is not None:
            resolved[nm] = []            # guard (HLO is SSA; belt & braces)
            s: set = set()
            for o2 in ci.operands:
                s.update(_resolve(o2))
            got = sorted(s)
        resolved[nm] = got
        return got

    def _union_deps(names: List[str]) -> List[int]:
        s: set = set()
        for o2 in names:
            s.update(_resolve(o2))
        return sorted(s)

    def _dep_edges(names: List[str]) -> Tuple[List[int], List[float]]:
        """deps + per-edge operand bytes (split evenly when one operand
        resolves to several producers, e.g. a while's dataflow sinks)."""
        acc: Dict[int, float] = {}
        for o2 in names:
            idxs = _resolve(o2)
            if not idxs:
                continue
            share = _single_operand_bytes(o2, comp) / len(idxs)
            for j in idxs:
                acc[j] = acc.get(j, 0.0) + share
        deps = sorted(acc)
        return deps, [acc[j] for j in deps]

    for name in comp.order:
        instr = comp.instrs[name]
        opcode = instr.opcode
        cls = _classify(opcode)
        if cls == "free":
            continue
        if opcode == "fusion":
            callee = _called(instr.attrs)
            flops = trans = 0.0
            dot_dims = None
            tbo: Dict[str, float] = defaultdict(float)
            vbo: Dict[str, float] = defaultdict(float)
            callee_comp = comps.get(callee) if callee else None
            if callee_comp is not None:
                inner: List[OpStat] = []
                _cost_computation(callee_comp, comps, npart, 1.0, inner,
                                  inline_fusions)
                for o in inner:
                    flops += o.flops * o.count
                    trans += o.transcendentals * o.count
                    for k, v in o.trans_by_opcode.items():
                        tbo[k] += v * o.count
                    for k, v in o.vpu_by_opcode.items():
                        vbo[k] += v * o.count
                    if o.dot_dims is not None:
                        dot_dims = o.dot_dims
            rd_b, wr_b = _fusion_boundary_bytes(instr, comp, callee_comp)
            deps, dep_b = _dep_edges(instr.operands)
            out.append(OpStat(name, "fusion",
                              "matmul" if dot_dims else "elementwise",
                              instr.dtype, flops=flops, transcendentals=trans,
                              bytes_accessed=rd_b + wr_b, read_bytes=rd_b,
                              write_bytes=wr_b, count=mult,
                              dot_dims=dot_dims, trans_by_opcode=dict(tbo),
                              vpu_by_opcode=dict(vbo),
                              deps=deps, dep_bytes=dep_b))
            producer[name] = [len(out) - 1]
            continue
        if opcode in ("while",):
            body = None
            cond = None
            bm = re.search(r"body=%?([\w.\-]+)", instr.attrs)
            cm = re.search(r"condition=%?([\w.\-]+)", instr.attrs)
            if bm:
                body = bm.group(1)
            if cm:
                cond = cm.group(1)
            trips = 1
            if cond and cond in comps:
                trips = _while_trip_count(comps[cond], comps)
            if body and body in comps:
                start = len(out)
                odeps = [_resolve(o2) for o2 in instr.operands]
                _cost_computation(comps[body], comps, npart, mult * trips, out,
                                  inline_fusions,
                                  param_deps=_callee_param_deps(comps[body],
                                                                odeps))
                producer[name] = (_group_sinks(out, start)
                                  or _union_deps(instr.operands))
            else:
                producer[name] = _union_deps(instr.operands)
            continue
        if opcode in ("call", "async-start"):
            callee = _called(instr.attrs)
            if callee and callee in comps:
                start = len(out)
                odeps = [_resolve(o2) for o2 in instr.operands]
                _cost_computation(comps[callee], comps, npart, mult, out,
                                  inline_fusions,
                                  param_deps=_callee_param_deps(comps[callee],
                                                                odeps))
                producer[name] = (_group_sinks(out, start)
                                  or _union_deps(instr.operands))
            else:
                producer[name] = _union_deps(instr.operands)
            continue
        if opcode == "conditional":
            # cost the most expensive branch (throwaway flops-only pass to
            # pick it, then re-cost into ``out`` so dep indices are global)
            branches = re.findall(r"branch_computations=\{([^}]*)\}", instr.attrs)
            names = []
            if branches:
                names = [b.strip().lstrip("%") for b in branches[0].split(",")]
            else:
                names = [x for x in
                         re.findall(r"(?:true|false)_computation=%?([\w.\-]+)",
                                    instr.attrs)]
            best_nm: Optional[str] = None
            best_j = -1
            best_f = -1.0
            for j, nm in enumerate(names):
                if nm in comps:
                    cand: List[OpStat] = []
                    _cost_computation(comps[nm], comps, npart, mult, cand,
                                      inline_fusions)
                    f = sum(o.flops * o.count for o in cand)
                    if f > best_f:
                        best_nm, best_j, best_f = nm, j, f
            if best_nm is not None:
                start = len(out)
                # branch k consumes conditional operand k+1 (0 is the pred)
                if best_j + 1 < len(instr.operands):
                    odeps = [_resolve(instr.operands[best_j + 1])]
                else:
                    odeps = [_union_deps(instr.operands)]
                _cost_computation(comps[best_nm], comps, npart, mult, out,
                                  inline_fusions,
                                  param_deps=_callee_param_deps(comps[best_nm],
                                                                odeps))
                producer[name] = (_group_sinks(out, start)
                                  or _union_deps(instr.operands))
            else:
                producer[name] = _union_deps(instr.operands)
            continue

        in_b = _operand_bytes(instr, comp)
        out_b = instr.tuple_bytes if instr.is_tuple else instr.out_bytes
        # sliced-access ops touch the region, not the buffer (and XLA
        # in-places DUS): same modeling as _fusion_boundary_bytes.
        if opcode in ("dynamic-slice", "slice"):
            in_b = out_b
        elif opcode == "dynamic-update-slice":
            upd = (_single_operand_bytes(instr.operands[1], comp)
                   if len(instr.operands) > 1 else out_b)
            in_b, out_b = upd, upd
        elif opcode == "gather":
            in_b = out_b + sum(_single_operand_bytes(o, comp)
                               for o in instr.operands[1:])
        elif opcode == "convert":
            # a convert whose only consumers are dots is fused into the
            # MXU operand read stream on TPU (int8/bf16 KV caches, bf16
            # weights into f32-accumulating dots): the widened copy is
            # never written to HBM (modeling rule I-5, DESIGN.md §9).
            cons = consumers.get(name, ())
            if cons and all(comp.instrs[c].opcode in ("dot", "convolution")
                            for c in cons if c in comp.instrs):
                out_b = 0.0
        deps, dep_b = _dep_edges(instr.operands)
        stat = OpStat(name, opcode, cls, instr.dtype,
                      bytes_accessed=in_b + out_b, read_bytes=in_b,
                      write_bytes=out_b, count=mult,
                      deps=deps, dep_bytes=dep_b)
        nelems = max(1, math.prod(instr.shape))
        if cls == "matmul":
            if opcode == "dot":
                stat.flops, stat.dot_dims = _dot_cost(instr, comp)
            else:
                stat.flops = _conv_cost(instr, comp)
        elif cls == "transcendental":
            stat.flops = float(nelems)
            stat.transcendentals = float(nelems)
            stat.trans_by_opcode = {opcode: float(nelems)}
        elif cls == "elementwise":
            stat.flops = float(nelems)
            stat.vpu_by_opcode = {opcode: float(nelems)}
        elif cls == "reduce":
            stat.flops = float(in_b / max(DTYPE_BYTES.get(instr.dtype, 4), 1))
        elif cls == "collective":
            stat.comm_bytes = in_b
            stat.group_size = _group_size(instr.attrs, npart)
            stat.opcode = COLLECTIVES[opcode]
        out.append(stat)
        producer[name] = [len(out) - 1]


def parse_program(text: str) -> Program:
    comps, entry, npart = parse_computations(text)
    # fallback: entry = computation containing while/largest
    if entry not in comps and comps:
        entry = max(comps, key=lambda c: len(comps[c].order))
    ops: List[OpStat] = []
    if entry in comps:
        _cost_computation(comps[entry], comps, npart, 1.0, ops, True)
    return Program(ops=ops, entry=entry, n_partitions=npart)
