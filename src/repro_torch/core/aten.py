"""ATen frontend: a PyTorch step captured as an ATen graph -> ``Program``.

    gm = capture(step, params, opt_state, batch)      # fake tensors
    prog = parse_graph(gm)                            # the Program IR
    report = simulate(gm, hw=H100, engine="both")     # or simulate(prog)

The counterpart of the reference's path from ``jax.jit(step).lower(...)
.compile()`` through ``hlo.parse_program``.  ``capture`` traces ``fn`` with
``make_fx`` over fake tensors: the forward, the backward that
``torch.autograd.grad`` runs and the optimizer land in one graph of ATen
ops, with nothing computed and no tensor of the step allocated (only the
few-byte constants it makes from Python numbers are; pass fake tensors
made under a ``FakeTensorMode`` to allocate none for the inputs either).  The
decomposition table is core ATen's without the composites that eager
PyTorch runs as one kernel (``COMPOSITES``: ``_softmax``, ``silu``,
``_softmax_backward_data``, ...), so every op arrives either as a core ATen
op or as one of those.  The port's kernels arrive as their custom ops
(``torch.ops.repro_torch.*``), one node per call.

``parse_graph`` builds the same ``OpStat`` records as ``hlo.parse_program``
under DESIGN.md §9's rules restated for eager ATen:

* **Opcode names.**  Each ATen op takes the HLO opcode that ``hlo``
  classifies (``mm``/``bmm``/``addmm`` -> ``dot`` with ``dot_dims``,
  ``exp`` -> ``exponential``, ``sigmoid`` -> ``logistic``, ``div`` ->
  ``divide``, ``where`` -> ``select``, ``_to_copy`` -> ``convert``,
  ``sum``/``amax``/``mean`` -> ``reduce``, ``cumsum`` -> ``reduce-window``,
  ``embedding``/``index``/``gather`` -> ``gather``, ``index_put``/
  ``scatter``/``slice_scatter`` -> ``scatter``, ``cat`` -> ``concatenate``,
  ``constant_pad_nd`` -> ``pad``, ``clone`` -> ``copy``, fills -> ``broadcast``,
  ``arange`` -> ``iota``; ``OPCODES``), so the per-opcode tables of
  ``hwspec`` apply; elementwise ops count in ``vpu_by_opcode``,
  transcendentals in ``trans_by_opcode``.  A kept composite is one
  ``fusion`` op whose per-element opcode counts are its parts'.  An op with
  no rule raises and names itself: nothing is counted as elementwise
  silently.
* **Views are free** (``view``, ``_unsafe_view``, ``permute``, ``t``,
  ``transpose``, ``expand``, ``(un)squeeze``, ``select``, ``slice``,
  ``alias``, ``detach``), like ``bitcast``, and so is ``empty``; graph
  edges resolve through them into ``deps``/``dep_bytes``.
* **I-1 with a fusion of one op.**  Every other op is a kernel of its own,
  because eager PyTorch launches one: it reads its operands and writes its
  outputs.  An operand counts the elements its view touches: a stride-0
  ``expand`` reads its base once.
* **What the MoE, vlm, audio and int8 paths add.**  ``sort`` and ``topk``
  -> ``sort``, the reference's opcode for ``argsort``/``top_k``: data
  movement, charged its bytes; ``searchsorted`` -> ``compare``, an
  elementwise op of ceil(log2(N + 1)) compares an output element (a binary
  search over the N sorted entries), which reads both operands;
  ``index_add`` (out of place) -> ``scatter``, ``repeat_interleave`` ->
  ``gather``, ``any`` -> ``reduce``, ``round`` -> ``round-nearest-even``;
  ``scatter_`` and ``index_add_`` write in place (I-3 below).  The int8 and
  f16 casts of the quantized cache are ``_to_copy`` -> ``convert`` with
  their real dtypes (``s8``, ``f16``).
* **I-2.**  An operand reached through a ``slice`` or ``select`` reads the
  view's elements, not the base's.  A gather reads the gathered rows and
  its indices.
* **I-3.**  An in-place write into a view (``copy_``, ``index_copy_``,
  ``index_put_``, ``scatter_``, ``index_add_``, as into a cache or the MoE
  combine) costs the updated region, read and written; later readers of
  the buffer depend on it.
* **I-4 has nothing to do:** Python loops (the layers, ``ops.ssd_scan``'s
  chunk recurrence) arrive unrolled, every op with count 1.
* **I-5 does not hold in eager.**  A ``_to_copy`` feeding a ``mm`` is a
  kernel that writes the cast copy, and is charged.
* **The kernels' custom ops** are ``OpStat(opcode="custom-call",
  opclass="data")`` with their operand and output bytes and no FLOPs,
  exactly as the reference's parser costs a Pallas custom-call.
* **Dtypes are real** (``bf16``, ``f32``, ``s64``, ``pred``, ...) and the
  program says so (``Program.exact_dtypes``): the cost model does not
  de-normalize its f32 ops to ``compute_dtype`` (DESIGN.md §7), because
  they are f32 on the device (the AdamW state, the SSD recurrence, the
  losses).
"""
from __future__ import annotations

import math
import operator
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from .hlo import OpStat, Program, _classify

DTYPE_NAMES = {
    torch.bool: "pred", torch.uint8: "u8", torch.int8: "s8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32",
    torch.float64: "f64",
}

# ops that only re-describe memory: no kernel, no bytes
VIEWS = {"view", "_unsafe_view", "permute", "t", "transpose", "expand",
         "unsqueeze", "squeeze", "select", "slice", "alias", "detach"}
# allocations: no kernel, no bytes (on CUDA the decompositions leave some
# that nothing reads)
ALLOCS = {"empty"}

# ATen op (overload packet name) -> HLO opcode
OPCODES = {
    # matmul class
    "mm": "dot", "bmm": "dot", "addmm": "dot", "convolution": "convolution",
    # elementwise
    "add": "add", "sub": "subtract", "mul": "multiply", "neg": "negate",
    "abs": "abs", "maximum": "maximum", "clamp": "clamp", "where": "select",
    "eq": "compare", "ne": "compare", "lt": "compare", "le": "compare",
    "gt": "compare", "ge": "compare", "bitwise_or": "or",
    "logical_and": "and", "bitwise_not": "not", "_to_copy": "convert",
    "full": "broadcast", "full_like": "broadcast", "scalar_tensor": "broadcast",
    "arange": "iota",
    # transcendental
    "exp": "exponential", "log": "log", "tanh": "tanh", "sigmoid": "logistic",
    "sin": "sine", "cos": "cosine", "pow": "power", "sqrt": "sqrt",
    "rsqrt": "rsqrt", "div": "divide", "reciprocal": "divide",
    # reduce
    "sum": "reduce", "mean": "reduce", "amax": "reduce",
    "cumsum": "reduce-window",
    # data movement
    "embedding": "gather", "index": "gather", "index_select": "gather",
    "gather": "gather", "scatter": "scatter", "scatter_add": "scatter",
    "index_put": "scatter", "slice_scatter": "scatter",
    "cat": "concatenate", "constant_pad_nd": "pad", "clone": "copy",
    "lift_fresh_copy": "copy", "flip": "reverse",
    # MoE routing and the int8 cache
    "sort": "sort", "topk": "sort", "searchsorted": "compare",
    "index_add": "scatter", "repeat_interleave": "gather", "any": "reduce",
    "round": "round-nearest-even",
}
# in-place writes into a buffer (I-3): the region is read and written
REGION_WRITES = {"copy_", "index_copy_", "index_put_", "scatter_",
                 "index_add_"}

# composites eager PyTorch runs as one kernel: kept whole (not decomposed)
# and costed as one fusion, with per-output-element opcode counts
COMPOSITES: Dict[str, Dict[str, Dict[str, float]]] = {
    "_softmax": {"trans": {"exponential": 1, "divide": 1},
                 "vpu": {"maximum": 1, "subtract": 1, "add": 1}},
    "_softmax_backward_data": {"trans": {},
                               "vpu": {"multiply": 2, "subtract": 1,
                                       "add": 1}},
    "silu": {"trans": {"logistic": 1}, "vpu": {"multiply": 1}},
    "silu_backward": {"trans": {"logistic": 1},
                      "vpu": {"subtract": 1, "multiply": 3, "add": 1}},
    "softplus": {"trans": {"exponential": 1, "log-plus-one": 1, "divide": 1},
                 "vpu": {"multiply": 1, "compare": 1, "select": 1}},
    "softplus_backward": {"trans": {"exponential": 1, "divide": 1},
                          "vpu": {"multiply": 2, "add": 1, "compare": 1,
                                  "select": 1}},
    "gelu": {"trans": {"erf": 1}, "vpu": {"multiply": 3, "add": 1}},
    "gelu_backward": {"trans": {"erf": 1, "exponential": 1},
                      "vpu": {"multiply": 5, "add": 2}},
}


def _packet(target) -> str:
    return target.overloadpacket.__name__


def decompositions() -> Dict[Any, Callable]:
    """Core ATen's decomposition table without ``COMPOSITES``."""
    from torch._decomp import core_aten_decompositions
    return {op: fn for op, fn in core_aten_decompositions().items()
            if _packet(op) not in COMPOSITES}


def capture(fn: Callable, *args) -> torch.fx.GraphModule:
    """``fn(*args)`` as one ATen graph, traced over fake tensors: no kernel
    runs and no tensor of the step is allocated.  ``args`` may be real
    tensors or fake ones (made under a ``FakeTensorMode``), in pytrees."""
    return make_fx(fn, tracing_mode="fake",
                   decomposition_table=decompositions())(*args)


# ------------------------------------------------------------------ parsing
def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _touched_bytes(t: torch.Tensor) -> float:
    """Bytes of the elements a view touches: stride-0 dims count once."""
    if t.numel() == 0:
        return 0.0
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return float(n * t.element_size())


def _dtype(t: torch.Tensor) -> str:
    try:
        return DTYPE_NAMES[t.dtype]
    except KeyError:
        raise NotImplementedError(f"core.aten: no HLO dtype for {t.dtype}")


def _dot(name: str, args, out: torch.Tensor) -> Tuple[float, tuple]:
    """(flops, (M, N, K)) of mm / bmm / addmm."""
    a, b = args[1:3] if name == "addmm" else args[:2]
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    return 2.0 * out.numel() * K, (M, N, K)


def _conv_flops(args, out: torch.Tensor) -> float:
    """As ``hlo._conv_cost``: 2 * out * (kernel elements / out channels)."""
    w = args[1]
    out_ch = out.shape[1] if out.dim() > 1 else 1
    return 2.0 * out.numel() * max(1, w.numel() // max(out_ch, 1))


def parse_graph(gm: torch.fx.GraphModule) -> Program:
    """The ``Program`` of a captured graph (module docstring's rules), with
    ``exact_dtypes`` set."""
    ops: List[OpStat] = []
    root: Dict[str, str] = {}          # node -> the buffer it shows
    writers: Dict[str, List[int]] = {}  # buffer -> ops whose writes it holds

    def operand_edges(tensor_args) -> Tuple[List[int], List[float]]:
        acc: Dict[int, float] = {}
        for node, t in tensor_args:
            idxs = writers.get(root.get(node.name, node.name), [])
            if not idxs:
                continue
            share = _touched_bytes(t) / len(idxs)
            for j in idxs:
                acc[j] = acc.get(j, 0.0) + share
        deps = sorted(acc)
        return deps, [acc[j] for j in deps]

    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            root[node.name] = node.name
            writers[node.name] = []
            continue
        if node.op != "call_function":
            continue
        target = node.target
        val = node.meta.get("val")
        if target is operator.getitem:       # one output of an op
            root[node.name] = node.name
            writers[node.name] = writers[node.args[0].name]
            continue
        if not isinstance(target, torch._ops.OpOverload):
            raise NotImplementedError(
                f"core.aten: no lowering rule for {target!r} ({node.name})")
        name = _packet(target)
        if name in VIEWS:
            base = node.args[0]
            root[node.name] = root.get(base.name, base.name)
            continue
        if name in ALLOCS:
            root[node.name] = node.name
            writers[node.name] = []
            continue

        # operands: (node, value) for every tensor argument, in order
        tensor_args = []
        flat_args = list(node.args) + list(node.kwargs.values())
        for a in flat_args:
            for n in (a if isinstance(a, (list, tuple)) else [a]):
                if isinstance(n, torch.fx.Node):
                    for t in _tensors(n.meta.get("val")):
                        tensor_args.append((n, t))
        args_val = [a.meta.get("val") if isinstance(a, torch.fx.Node) else a
                    for a in node.args]
        outs = _tensors(val)
        if not outs:
            raise NotImplementedError(
                f"core.aten: {target} ({node.name}) returns no tensor")
        in_b = sum(_touched_bytes(t) for _, t in tensor_args)
        out_b = sum(float(t.numel() * t.element_size()) for t in outs)
        dtype = _dtype(outs[0])
        deps, dep_b = operand_edges(tensor_args)
        inplace = name in REGION_WRITES

        if target.namespace == "repro_torch":
            opcode, cls = "custom-call", "data"
        elif name in COMPOSITES:
            opcode, cls = "fusion", "elementwise"
        elif inplace:
            opcode, cls = ("copy" if name == "copy_" else "scatter"), "data"
        elif name in OPCODES:
            opcode = OPCODES[name]
            cls = _classify(opcode)
        else:
            raise NotImplementedError(
                f"core.aten: no lowering rule for {target} ({node.name})")

        if inplace:
            # I-3: the region written into operand 0's buffer, read and
            # written (a copy_'s destination view, an index_*_'s values)
            region = tensor_args[0 if name == "copy_" else -1][1]
            in_b = out_b = _touched_bytes(region)
        elif opcode == "gather":
            # the gathered rows and the indices, not the whole table (I-2)
            in_b = out_b + sum(_touched_bytes(t) for _, t in tensor_args[1:])

        stat = OpStat(node.name, opcode, cls, dtype,
                      bytes_accessed=in_b + out_b, read_bytes=in_b,
                      write_bytes=out_b, deps=deps, dep_bytes=dep_b)
        nelems = float(max(1, outs[0].numel()))
        if opcode == "fusion":
            parts = COMPOSITES[name]
            stat.trans_by_opcode = {k: v * nelems
                                    for k, v in parts["trans"].items()}
            stat.vpu_by_opcode = {k: v * nelems
                                  for k, v in parts["vpu"].items()}
            stat.transcendentals = sum(stat.trans_by_opcode.values())
            stat.flops = stat.transcendentals + sum(stat.vpu_by_opcode.values())
        elif cls == "matmul":
            if opcode == "dot":
                stat.flops, stat.dot_dims = _dot(name, args_val, outs[0])
            else:
                stat.flops = _conv_flops(args_val, outs[0])
        elif cls == "transcendental":
            stat.flops = stat.transcendentals = nelems
            stat.trans_by_opcode = {opcode: nelems}
        elif name == "searchsorted":   # a binary search an output element
            steps = math.ceil(math.log2(tensor_args[0][1].shape[-1] + 1))
            stat.flops = nelems * steps
            stat.vpu_by_opcode = {opcode: stat.flops}
        elif cls == "elementwise":
            stat.flops = nelems
            stat.vpu_by_opcode = {opcode: nelems}
        elif cls == "reduce":
            stat.flops = float(max(1, tensor_args[0][1].numel()))
        ops.append(stat)
        idx = len(ops) - 1
        if inplace:
            buf = root.get(tensor_args[0][0].name, tensor_args[0][0].name)
            root[node.name] = buf
            writers[buf] = sorted(set(writers.get(buf, [])) | {idx})
        else:
            root[node.name] = node.name
            writers[node.name] = [idx]
    prog = Program(ops=ops, entry=type(gm).__name__, n_partitions=1)
    prog.exact_dtypes = True
    return prog
