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
  ``argmax``/``argmin`` (the serving decode step's) -> ``reduce`` at two
  FLOPs an input element, as the reference's parser charges the variadic
  reduce over the values and an iota that XLA writes for them; ``relu``
  (nemotron-4-340b's squared ReLU) -> ``maximum``, with 0;
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
* **I-4, as the reference's rule: a loop's body counts once, times its
  trips.**  ``repeat`` is the port's ``lax.scan``.  Eager, and in the
  default capture, it runs its Python loop and every op has count 1.  In a
  loop-aware capture (``capture(..., loops=True)``) it traces the body once,
  on iteration 0's slice, and tags every node traced for it, the nodes of
  the body's backward included, with the loop's trips
  (``node.meta["loop"]``: ``(loop id, trips)`` pairs, outermost first); an
  op's count is the product of its tags, so a layer inside the
  microbatch loop counts ``n_micro x n_layers``.  The layers' parameter
  slices are views read in the body (I-2); their gradient is the stack of
  the n layers' slices, written once (n slices read and written, as the
  unrolled capture's and as n dynamic-update-slices of one slice each),
  each slice's reduced into the slice's placements on a mesh in the
  body's backward (``grad_in_placements``: its collectives count the
  trips and carry ``meta["grad_of"]``, the leaf's name in ``xs``).  A
  stacked output is the stack of the one iteration's output n times, the
  bytes of the unrolled stack.  A tensor the body reads unchanged on every
  iteration (``consts``) has its gradient summed n - 1 times, as autograd
  sums the unrolled layers' contributions.  The loops inside a layer run
  through ``repeat`` too: the blocked attention's KV blocks and the SSD
  inter-chunk recurrence (``models.ssm._recurrence``, ``ops.ssd_scan``),
  each counted its trips times the layers' and microbatches'.
* **I-5 does not hold in eager.**  A ``_to_copy`` feeding a ``mm`` is a
  kernel that writes the cast copy, and is charged.
* **The kernels' custom ops** are ``OpStat(opcode="custom-call",
  opclass="data")`` with their operand and output bytes and no FLOPs,
  exactly as the reference's parser costs a Pallas custom-call.
* **Collectives.**  A DTensor redistribute or a functional collective
  traces to ``_c10d_functional`` ops: ``all_gather_into_tensor`` ->
  ``all-gather``, ``reduce_scatter_tensor`` -> ``reduce-scatter``,
  ``all_reduce`` -> ``all-reduce``, ``all_to_all_single`` -> ``all-to-all``
  and ``broadcast`` -> ``all-gather`` (``hlo.COLLECTIVES`` maps
  ``collective-broadcast`` so).  Each is ``opclass="collective"`` with
  ``comm_bytes`` its operand's bytes at its dtype and ``group_size`` its
  process group's size, as ``hlo`` charges the HLO collectives.
  ``capture`` records each group's size in the node's ``meta`` while the
  group exists (``all_reduce`` names only its group), so ``parse_graph``
  needs no live group.  ``wait_tensor`` is free, like ``all-gather-done``:
  its readers depend on the collective.  Any other ``_c10d_functional`` op
  raises.  A gather on a dim other than 0 arrives as a gather on dim 0,
  ``split_with_sizes`` (a view) and a ``cat`` (a kernel, charged).
* **Dtypes are real** (``bf16``, ``f32``, ``s64``, ``pred``, ...) and the
  program says so (``Program.exact_dtypes``): the cost model does not
  de-normalize its f32 ops to ``compute_dtype`` (DESIGN.md §7), because
  they are f32 on the device (the AdamW state, the SSD recurrence, the
  losses).
"""
from __future__ import annotations

import collections
import functools
import math
import operator
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
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
         "unsqueeze", "squeeze", "select", "slice", "alias", "detach",
         "split_with_sizes", "as_strided", "detach_"}
# allocations: no kernel, no bytes (on CUDA the decompositions leave some
# that nothing reads)
ALLOCS = {"empty", "empty_strided"}

# ATen op (overload packet name) -> HLO opcode
OPCODES = {
    # matmul class
    "mm": "dot", "bmm": "dot", "addmm": "dot", "convolution": "convolution",
    # elementwise
    "add": "add", "sub": "subtract", "mul": "multiply", "neg": "negate",
    "abs": "abs", "maximum": "maximum", "clamp": "clamp", "where": "select",
    "relu": "maximum",
    "eq": "compare", "ne": "compare", "lt": "compare", "le": "compare",
    "gt": "compare", "ge": "compare", "bitwise_or": "or",
    "logical_and": "and", "bitwise_and": "and", "bitwise_not": "not",
    "_to_copy": "convert",
    "full": "broadcast", "full_like": "broadcast", "scalar_tensor": "broadcast",
    "arange": "iota",
    # transcendental
    "exp": "exponential", "log": "log", "tanh": "tanh", "sigmoid": "logistic",
    "sin": "sine", "cos": "cosine", "pow": "power", "sqrt": "sqrt",
    "rsqrt": "rsqrt", "div": "divide", "reciprocal": "divide",
    # reduce
    "sum": "reduce", "mean": "reduce", "amax": "reduce",
    "argmax": "reduce", "argmin": "reduce", "max": "reduce", "min": "reduce",
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
# _c10d_functional ops (overload packet name) -> HLO collective opcode
COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "all-gather",
}
COLLECTIVE_NAMESPACE = "_c10d_functional"
# the wait on a collective's result: free, its readers depend on the
# collective
WAITS = {"wait_tensor"}
# reduces that carry an index beside each value: XLA lowers them to one
# variadic reduce over the values and an iota, which the reference's parser
# charges an element of each operand (``max.dim``/``min.dim`` return both,
# as DTensor's argmax computes it)
ARG_REDUCES = {"argmax", "argmin"}
VALUE_INDEX_REDUCES = {"max", "min"}
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


def capture(fn: Callable, *args, loops: bool = False) -> torch.fx.GraphModule:
    """``fn(*args)`` as one ATen graph, traced over fake tensors: no kernel
    runs and no tensor of the step is allocated.  ``args`` may be real
    tensors or fake ones (made under a ``FakeTensorMode``), in pytrees.

    With ``loops`` each ``repeat`` in ``fn`` is traced once and tagged with
    its trips (I-4).  Its values are then not the step's, so ``args`` must
    be fake or ``meta`` tensors; a tensor with storage raises."""
    if loops:
        from torch._subclasses.fake_tensor import FakeTensor
        for t in pytree.tree_leaves(args):
            if isinstance(t, torch.Tensor) and not (
                    isinstance(t, FakeTensor) or t.is_meta):
                raise ValueError(
                    "core.aten.capture(loops=True) traces each loop's body "
                    "once, so its values are not the step's: pass fake or "
                    "meta tensors, not tensors with storage")
        fn = _loop_aware(fn)
    global _CAPTURING
    _CAPTURING, outer = True, _CAPTURING
    try:
        gm = make_fx(fn, tracing_mode="fake",
                     decomposition_table=decompositions())(*args)
    finally:
        _CAPTURING = outer
    record_group_sizes(gm)
    return gm


# set while ``capture`` traces (loop-aware or not)
_CAPTURING = False


# ------------------------------------------------------------ loops (I-4)
_LOOPS: Optional["_LoopCapture"] = None


def _loop_aware(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def traced(*args):
        global _LOOPS
        from torch.fx.experimental.proxy_tensor import get_proxy_mode
        _LOOPS = st = _LoopCapture(get_proxy_mode().tracer.graph)
        try:
            return fn(*args)
        finally:
            _LOOPS = None
            st.finish()
    return traced


class _LoopCapture:
    """Which loops the nodes being traced belong to.  ``tag`` stamps the
    nodes traced since its last call with the current ``loops`` (loop ids,
    outermost first) and ``bwd`` (the loop whose backward is being
    traced); the state changes only through ``enter``, which tags first.
    A loop's trips are settled after its body is traced (``trips``);
    ``finish`` writes them into the nodes, ``node.meta["loop"]`` = ((loop
    id, trips), ...), and drops the loops of one trip (an iteration traced
    on its own)."""

    def __init__(self, graph: torch.fx.Graph):
        self.graph = graph
        self.cursor = graph._root.prev       # the last node traced so far
        self.loops: tuple = ()
        self.bwd: Optional[int] = None
        self.trips: Dict[int, int] = {}
        self.saved: Optional[tuple] = None   # (loops, bwd) a backward began at
        self.hooked: set = set()             # grad_fns of the bodies traced
        self.sites: Dict[tuple, list] = {}   # body site -> forward loop ids
        self.alias: Dict[int, int] = {}      # recomputed loop -> forward's

    def new_loop(self, trips: int) -> int:
        self.trips[len(self.trips)] = trips
        return len(self.trips) - 1

    def tag(self, **meta) -> None:
        node = self.cursor.next
        while node is not self.graph._root:
            if self.loops:
                node.meta["loop"] = self.loops
            if self.bwd is not None:
                node.meta["loop_bwd"] = self.bwd
            node.meta.update(meta)
            self.cursor, node = node, node.next

    def enter(self, loops: tuple, bwd: Optional[int]) -> None:
        self.tag()
        self.loops, self.bwd = loops, bwd

    def backward_hook(self, loops: tuple, bwd: Optional[int]):
        """A grad_fn's pre-hook: its backward, and the sums of the gradients
        it passes on, belong to the loops its forward ran in.  The state a
        backward pass began with returns when the pass ends."""
        def hook(grad_outputs):
            if self.saved is None:
                self.saved = (self.loops, self.bwd)
                torch.autograd.Variable._execution_engine.queue_callback(
                    self._end_backward)
            self.enter(loops, bwd)
        return hook

    def _end_backward(self) -> None:
        self.enter(*self.saved)
        self.saved = None

    def recomputed(self, lid: int, site) -> None:
        """Loop ``lid`` traced for ``site`` (a body's code and traced
        iteration): in a backward it is the forward's loop of that site
        recomputed (a remat'ed layer's), the last one not yet matched, and
        takes its id, so that ``memory_analysis`` finds the buffers the
        forward's loop would have saved."""
        if self.saved is None:
            self.sites.setdefault(site, []).append(lid)
        elif self.sites.get(site):
            self.alias[lid] = self.sites[site].pop()

    def finish(self) -> None:
        self.tag()
        for node in self.graph.nodes:
            loops = tuple((self.alias.get(lid, lid), self.trips[lid])
                          for lid in node.meta.pop("loop", ())
                          if self.trips[lid] > 1)
            if loops:
                node.meta["loop"] = loops
            if self.trips.get(node.meta.get("loop_bwd"), 2) == 1:
                del node.meta["loop_bwd"]
            if self.trips.get(node.meta.get("loop_carry"), 2) == 1:
                del node.meta["loop_carry"]


class _Slice(torch.autograd.Function):
    """A stacked leaf's slices at ``picks`` (iterations 0 and 1: two
    views whatever n), views (the scan's dynamic-slice, I-2), one
    for each traced body; ``plan`` lists (pick, loop) for the bodies in
    order.  The gradient is the stack of the n iterations' slices, each
    body's as often as it stands for an iteration (n slices read and
    written), as ``unbind``'s backward stacks the unrolled layers'."""

    @staticmethod
    def forward(ctx, a, picks, plan):
        ctx.plan = plan
        ctx.set_materialize_grads(False)
        return tuple(a.select(0, j) for j in picks)

    @staticmethod
    def backward(ctx, *gs):
        ts = [gs[k] for k, lid in ctx.plan
              for _ in range(_LOOPS.trips[lid])]
        if all(g is None for g in ts):
            return None, None, None
        return _stack_loop(ts), None, None


class _Mark(torch.autograd.Function):
    """A loop's carry as it enters the body: a view, so that
    ``memory_analysis`` can find the carry a body's backward reads.  On a
    mesh (a DTensor carry, ``slot`` a dict) the gradient the body passes
    back for it is redistributed to the layout in which the gradient of
    the body's returned carry arrived (``_Arrived`` records it), so every
    iteration's backward receives the gradient in the layout the loop's
    exit gives it, as the reference's scan pins a carry's cotangent."""

    @staticmethod
    def forward(ctx, x, slot=None):
        ctx.slot = slot
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        want = ctx.slot.get("placements") if ctx.slot else None
        if want is not None and hasattr(g, "placements") \
                and tuple(g.placements) != want:
            g = g.redistribute(g.device_mesh, want)
        return g, None


class _Arrived(torch.autograd.Function):
    """A body's returned carry (a DTensor): records in ``slot`` the
    placements its gradient arrives in, for ``_Mark``."""

    @staticmethod
    def forward(ctx, x, slot):
        ctx.slot = slot
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.slot["placements"] = tuple(getattr(g, "placements", ())) or None
        return g, None


def _pinned(body: Callable, mark_all: bool) -> Callable:
    """``body`` with its carry's DTensor leaves that need a gradient passed
    through ``_Mark`` (every leaf that needs one with ``mark_all``) and
    the carry it returns through ``_Arrived``, leaf by leaf."""
    def run(carry, i, *args):
        leaves, spec = pytree.tree_flatten(carry)
        slots = [{} if isinstance(t, torch.Tensor) and t.requires_grad
                 and hasattr(t, "placements") else None for t in leaves]
        carry = pytree.tree_unflatten(
            [_Mark.apply(t, s) if s is not None or (
                mark_all and isinstance(t, torch.Tensor) and t.requires_grad)
             else t for t, s in zip(leaves, slots)], spec)
        if _LOOPS is not None and mark_all:
            _LOOPS.tag(loop_carry=_LOOPS.loops[-1])
        out, y = body(carry, i, *args)
        outs, ospec = pytree.tree_flatten(out)
        if len(outs) == len(slots):
            out = pytree.tree_unflatten(
                [_Arrived.apply(t, s) if s is not None and isinstance(
                    t, torch.Tensor) and t.requires_grad else t
                 for t, s in zip(outs, slots)], ospec)
        return out, y
    return run


def traced_as(fn: Callable, **meta):
    """``fn()``, the graph nodes it traces (inside a capture) stamped with
    ``meta``; outside a capture ``fn()`` as it is."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode
    mode = get_proxy_mode()
    if mode is None:
        return fn()
    graph = mode.tracer.graph
    last = graph._root.prev
    out = fn()
    node = last.next
    while node is not graph._root:
        node.meta.update(meta)
        node = node.next
    return out


class _GradIn(torch.autograd.Function):
    """A view of a DTensor whose gradient is redistributed to the view's
    placements: the transpose of a sharding constraint, as the reference's
    scan gives an ``xs`` slice's cotangent the slice's sharding.  The nodes
    of the redistribution carry ``meta["grad_of"]`` = ``name``."""

    @staticmethod
    def forward(ctx, x, name, keep):
        ctx.mesh, ctx.placements, ctx.leaf, ctx.keep = (
            x.device_mesh, tuple(x.placements), name, keep)
        ctx.set_materialize_grads(False)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g is None or not hasattr(g, "placements"):
            return g, None, None
        want = tuple(g.placements[m] if m in ctx.keep else p
                     for m, p in enumerate(ctx.placements))
        if tuple(g.placements) != want:
            g = traced_as(lambda: g.redistribute(ctx.mesh, want),
                          grad_of=ctx.leaf)
        return g, None, None


def grad_in_placements(x, name: str = ""):
    """``x`` (a parameter's slice) as a view whose gradient arrives in
    ``x``'s placements, reduced there in its own dtype (a partial sum over
    'data' reduce-scattered into the FSDP shard) as soon as the backward
    computes it, but on the mesh dims of the installed rules'
    ``keep_grad_dims``, where it stays as the backward gives it; a plain
    tensor, one that needs no gradient, or a DTensor on a mesh of one rank
    as it is."""
    if not (isinstance(x, torch.Tensor) and x.requires_grad
            and hasattr(x, "placements") and x.device_mesh.size() > 1):
        return x
    from ..parallel.sharding import current_rules
    rules = current_rules()
    return _GradIn.apply(x, name,
                         rules.keep_grad_dims if rules is not None else ())


def _leaf_names(tree) -> list:
    """'a/b' of each leaf of ``tree``, in ``tree_flatten``'s order."""
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in pytree.tree_flatten_with_path(tree)[0]]


class _Invariant(torch.autograd.Function):
    """A tensor every iteration of a body reads unchanged: its gradient is
    summed over the iterations the body stands for, trips - 1 adds, as
    autograd sums the unrolled iterations' contributions."""

    @staticmethod
    def forward(ctx, x, lid):
        ctx.lid = lid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        st = _LOOPS
        if st.trips[ctx.lid] > 1:
            outer = st.loops
            st.enter(outer + (st.new_loop(st.trips[ctx.lid] - 1),), st.bwd)
            g = g + g
            st.enter(outer, st.bwd)
        return g, None


class _StackLoop(torch.autograd.Function):
    """``torch.stack(ts, dim)`` whose backward hands each distinct tensor
    one slice of the gradient, its first place's: a body's y stands for
    each iteration's, whose slices the unrolled stack's backward hands out
    one an iteration (summing them would add what no iteration adds)."""

    @staticmethod
    def forward(ctx, dim, *ts):
        ctx.dim, ctx.n = dim, len(ts)
        ctx.first = {i for i, t in enumerate(ts)
                     if all(t is not u for u in ts[:i])}
        ctx.set_materialize_grads(False)
        return torch.stack(ts, dim)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return (None,) * (ctx.n + 1)
        gs = g.unbind(ctx.dim)
        return (None, *(gs[i] if i in ctx.first else None
                        for i in range(ctx.n)))


def _stack_loop(ts: list, dim: int = 0) -> torch.Tensor:
    """``torch.stack(ts, dim)`` of a collapsed loop's iterations, which
    repeat the body's tensor: marked so that ``memory_analysis`` counts
    each tensor as often as the stack reads it."""
    _LOOPS.tag()
    out = _StackLoop.apply(dim, *ts)
    _LOOPS.tag(loop_stack=True)
    return out


class _CarryGrad(torch.autograd.Function):
    """Views of (out, *carry) whose backward gives the carry a zero
    gradient where nothing else gives it one, in the carry's layout (a
    DTensor's zeros in its placements: autograd would materialize a plain
    tensor)."""

    @staticmethod
    def forward(ctx, out, *carry):
        ctx.set_materialize_grads(False)
        ctx.like = [_zeros_spec(c) for c in carry]
        return (out.view_as(out), *(c.view_as(c) for c in carry))

    @staticmethod
    def backward(ctx, g, *gs):
        return (g, *(_zeros(like) if gc is None else gc
                     for gc, like in zip(gs, ctx.like)))


def _zeros_spec(t: torch.Tensor) -> tuple:
    local = getattr(t, "_local_tensor", t)
    return (tuple(t.shape), t.stride(), t.dtype, local.device,
            tuple(local.shape), getattr(t, "device_mesh", None),
            tuple(getattr(t, "placements", ())))


def _zeros(spec: tuple) -> torch.Tensor:
    shape, stride, dtype, device, local, mesh, placements = spec
    z = torch.zeros(local, dtype=dtype, device=device)
    if mesh is None:
        return z
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(z, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def with_carry_grad(out: torch.Tensor, carry):
    """(``out``, ``carry``) after a ``repeat``, ``out`` a tensor that the
    step reads (its stacked ys, or a leaf of its final carry): the final
    carry's leaves (a tensor or a pytree of them) receive a gradient
    whenever ``out`` does, zeros where nothing reads them (materialized,
    as a scan's transpose runs every iteration with a zero cotangent for
    an unused carry).  So the last iteration's backward is every other
    iteration's, in the unrolled capture as in a loop-aware one, whose
    body stands for the last iteration too.  Outside ``capture``, and
    without a gradient, the two as they are: eager runs compute what they
    did (the zeros would reorder autograd's sums)."""
    leaves, spec = pytree.tree_flatten(carry)
    idx = [i for i, t in enumerate(leaves)
           if isinstance(t, torch.Tensor) and t.requires_grad]
    if not (_CAPTURING and idx and torch.is_grad_enabled()
            and out.requires_grad):
        return out, carry
    out, *views = _CarryGrad.apply(out, *(leaves[i] for i in idx))
    for i, v in zip(idx, views):
        leaves[i] = v
    return out, pytree.tree_unflatten(leaves, spec)


def stack(ts: list, dim: int = 0) -> torch.Tensor:
    """``torch.stack(ts, dim)``; a ``repeat``'s ys of a loop-aware capture
    hold the body's value for each iteration it stands for."""
    if _LOOPS is not None and len(set(map(id, ts))) < len(ts):
        return _stack_loop(ts, dim)
    return torch.stack(ts, dim)


def repeat(body: Callable, n: int, carry, xs: tuple = (), views: tuple = (),
           consts: tuple = ()):
    """``lax.scan`` of the port: ``carry, y = body(carry, i, *xs_i,
    *views_i, *consts)`` for i in range(n); returns (carry, [y_0, ...]).

    ``xs`` are pytrees of leaves stacked on dim 0 that the body reads
    (parameters): iteration i gets each leaf's ``unbind(0)[i]``.  ``views``
    are pytrees stacked likewise that the body may write in place (a
    decode cache): iteration i gets ``leaf[i]``.  ``consts`` are passed to
    every iteration as they are.

    On a mesh each iteration's backward hands the carry's gradient on in
    the layout the loop's exit gave it (``_Mark``), eager and captured
    alike: the body's backward is then the same for every iteration (the
    reference's scan pins a carry's cotangent as its value; mamba2's
    layers would otherwise hand on (Shard(0), Shard(0)) where the final
    norm gives (Shard(0), Replicate())).  Each ``xs`` slice's gradient is
    reduced into the slice's placements in its iteration's backward
    (``grad_in_placements``), as the reference's scan transposes a
    slice's cotangent in the slice's sharding: the stacked gradient
    leaves the loop in the parameter's placements, never whole.

    In a loop-aware capture the body is traced once and stands for the
    iterations whose ops are the same, as a scan's body.  Iteration 0 is
    traced on its own where the carry it returns differs from the one it
    took (in layout, in needing a gradient, a Python number become a
    tensor), as unrolled, and the body stands for the others.  The ys
    hold each traced body's y as often as it stands for an iteration
    (``stack`` stacks them).  A tensor that needs a gradient and that the
    body reads must come in through ``carry``, ``xs`` or ``consts``, or
    the capture raises."""
    st = _LOOPS
    grad = torch.is_grad_enabled()
    if st is None or n <= 1:
        unbound = []
        for tree in xs:
            leaves, spec = pytree.tree_flatten(tree)
            if grad:
                unbound.append((spec, [
                    [grad_in_placements(u, nm) for u in a.unbind(0)]
                    for a, nm in zip(leaves, _leaf_names(tree))]))
            else:
                unbound.append((spec, [a.unbind(0) for a in leaves]))
        run = _pinned(body, False) if grad else body
        ys = []
        for i in range(n):
            args = [pytree.tree_unflatten([u[i] for u in us], spec)
                    for spec, us in unbound]
            args += [_index(v, i) for v in views]
            carry, y = run(carry, i, *args, *consts)
            ys.append(y)
        return carry, ys

    picks = (0, 1)               # the iterations traced: see below
    plan: list = []
    slices, names = [], []
    for tree in xs:
        leaves, spec = pytree.tree_flatten(tree)
        outs = [_Slice.apply(a, picks, plan) for a in leaves]
        slices.append([pytree.tree_unflatten([o[k] for o in outs], spec)
                       for k in range(len(picks))])
        names.append(pytree.tree_unflatten(_leaf_names(tree), spec))
    base = (st.loops, st.bwd)

    def trace(k: int, carry) -> dict:
        """``body`` traced for iteration ``picks[k]``, as a loop whose trips
        are settled later."""
        i = picks[k]
        lid = st.new_loop(n)
        st.recomputed(lid, (getattr(body, "__code__", body), k))
        rest = [_index(v, i) for v in views]
        rest += [_Invariant.apply(c, lid) if isinstance(c, torch.Tensor)
                 and c.requires_grad else c for c in consts]
        st.enter(base[0] + (lid,), base[1])
        start = torch._C._autograd._get_sequence_nr()
        # each slice's gradient reduced into its placements in the body's
        # backward, as the unrolled loop's (``grad_in_placements``)
        args = [pytree.tree_map(grad_in_placements, s[k], tree)
                for s, tree in zip(slices, names)]
        out, y = _pinned(body, True)(carry, i, *args, *rest)
        st.enter(*base)
        return {"k": k, "lid": lid, "start": start, "carry_in": carry,
                "carry": out, "y": y}

    def settle(seg: dict, trips: int) -> list:
        st.trips[seg["lid"]] = trips
        plan.append((seg["k"], seg["lid"]))
        if torch.is_grad_enabled():
            loops, bwd = ((base[0] + (seg["lid"],), seg["lid"]) if trips > 1
                          else base)
            _hook_body(st, (seg["carry"], seg["y"]), seg["start"], loops,
                       bwd, base)
        return [seg["y"]] * trips

    seg = trace(0, carry)
    ys = []
    if _signature(seg["carry"]) != _signature(carry):
        ys += settle(seg, 1)
        seg = trace(1, seg["carry"])
    trips = n - picks[seg["k"]]
    if trips > 1 and _signature(seg["carry"]) != _signature(seg["carry_in"]):
        raise NotImplementedError(
            "core.aten.repeat: the carry changes on more than one iteration")
    ys += settle(seg, trips)
    return seg["carry"], ys


def _signature(carry) -> list:
    """What a body's ops depend on in its carry, besides the values."""
    out = [pytree.tree_structure(carry)]
    for t in pytree.tree_leaves(carry):
        if isinstance(t, torch.Tensor):
            local = getattr(t, "_local_tensor", t)     # a DTensor's shard
            out.append((type(t), tuple(t.shape), t.dtype, t.requires_grad,
                        tuple(getattr(t, "placements", ())), local.stride()))
        else:
            out.append(type(t))
    return out


def _index(tree, i: int):
    return pytree.tree_map(lambda a: a[i], tree, is_leaf=lambda a: a is None
                           ) if tree is not None else None


_BOUNDARY = ("_SliceBackward", "_InvariantBackward")


def _hook_body(st: _LoopCapture, outputs, start: int, loops: tuple,
               bwd: Optional[int], base: tuple) -> None:
    """Pre-hooks on the grad_fns a traced body made (sequence number
    ``start`` or later, reached from its outputs): their backward belongs
    to ``loops``; and on the grad_fns the body's inputs came from: the
    backward after the body's belongs to the loops around it, ``base``.
    A grad_fn of a loop nested in the body keeps its own loop's hook (it
    was traced first)."""
    todo = [t.grad_fn for t in pytree.tree_leaves(outputs)
            if isinstance(t, torch.Tensor) and t.grad_fn is not None
            and t.grad_fn._sequence_nr() >= start]
    seen = set()
    while todo:
        fn = todo.pop()
        if fn in seen:
            continue
        seen.add(fn)
        if fn not in st.hooked:
            fn.register_prehook(st.backward_hook(loops, bwd))
            st.hooked.add(fn)
        for nxt, _ in fn.next_functions:
            if nxt is None or nxt in seen:
                continue
            if nxt._sequence_nr() >= start and "AccumulateGrad" not in \
                    nxt.name():
                todo.append(nxt)
                continue
            if fn.name() != "_MarkBackward" and nxt.name() not in _BOUNDARY:
                raise NotImplementedError(
                    f"core.aten.repeat: the body reads a tensor that needs a "
                    f"gradient from outside ({nxt.name()} into {fn.name()}); "
                    "pass it in through carry, xs or consts")
            seen.add(nxt)
            nxt.register_prehook(st.backward_hook(*base))


def drop_dead_writes(gm: torch.fx.GraphModule) -> None:
    """Erase the in-place writes into an allocation that nothing reads
    after them, and what only they read: dead stores, which
    ``eliminate_dead_code`` keeps as side effects.  Torch 2.11's DTensor
    leaves them: it propagates an in-place op's sharding by running it on
    empty tensors of the global shape, once an op signature (its cache is
    cold in a new process); a ``masked_fill_`` there reads its allocation
    before it writes it (``copy_(x, where(mask, v, x))``)."""
    order = {n: i for i, n in enumerate(gm.graph.nodes)}
    for node in list(gm.graph.nodes):
        if node.op != "call_function" or not isinstance(
                node.target, torch._ops.OpOverload) \
                or _packet(node.target) not in ALLOCS:
            continue
        writes = [w for w in node.users
                  if not w.users and w.args and w.args[0] is node
                  and isinstance(w.target, torch._ops.OpOverload)
                  and _packet(w.target).endswith("_")]
        if writes and all(order[r] < min(order[w] for w in writes)
                          for r in node.users if r not in writes):
            for w in writes:
                gm.graph.erase_node(w)
    gm.graph.eliminate_dead_code()


def _is_collective(target) -> bool:
    return (isinstance(target, torch._ops.OpOverload)
            and target.namespace == COLLECTIVE_NAMESPACE)


def record_group_sizes(gm: torch.fx.GraphModule) -> None:
    """Each collective node's process-group size in ``node.meta
    ["group_size"]``, resolved from its ``group_name`` while the group
    exists."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for node in gm.graph.nodes:
        if node.op != "call_function" or not _is_collective(node.target) \
                or _packet(node.target) not in COLLECTIVE_OPS:
            continue
        names = [a.name for a in node.target._schema.arguments]
        i = names.index("group_name")
        group = node.kwargs.get("group_name",
                                node.args[i] if i < len(node.args) else None)
        node.meta["group_size"] = _resolve_process_group(group).size()


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


def trips(node: torch.fx.Node) -> int:
    """A node's count: the product of its loops' trips (I-4)."""
    return math.prod(n for _, n in node.meta.get("loop", ()))


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
        if target is operator.getitem:       # one output of an op or view
            src = node.args[0].name
            root[node.name] = root.get(src, src)
            continue
        if not isinstance(target, torch._ops.OpOverload):
            raise NotImplementedError(
                f"core.aten: no lowering rule for {target!r} ({node.name})")
        name = _packet(target)
        collective = _is_collective(target)
        if name in VIEWS or (collective and name in WAITS):
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
        # an elementwise op in place (``add_``, the accumulation of the
        # microbatches' gradients): charged as its out-of-place op, and
        # later readers of operand 0's buffer depend on it
        ew_inplace = (not inplace and name.endswith("_")
                      and name[:-1] in OPCODES
                      and _classify(OPCODES[name[:-1]]) == "elementwise")

        if collective:
            if name not in COLLECTIVE_OPS:
                raise NotImplementedError(
                    f"core.aten: no lowering rule for {target} ({node.name})")
            if "group_size" not in node.meta:
                raise NotImplementedError(
                    f"core.aten: {target} ({node.name}) has no group size; "
                    "capture it with core.aten.capture while its process "
                    "group exists")
            opcode, cls = COLLECTIVE_OPS[name], "collective"
        elif target.namespace == "repro_torch":
            opcode, cls = "custom-call", "data"
        elif name in COMPOSITES:
            opcode, cls = "fusion", "elementwise"
        elif inplace:
            opcode, cls = ("copy" if name == "copy_" else "scatter"), "data"
        elif ew_inplace:
            opcode, cls = OPCODES[name[:-1]], "elementwise"
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
                      write_bytes=out_b, deps=deps, dep_bytes=dep_b,
                      count=float(trips(node)))
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
        elif name in ARG_REDUCES or (name in VALUE_INDEX_REDUCES
                                     and len(outs) == 2):
            # a (value, index) pair an element
            stat.flops = 2.0 * max(1, tensor_args[0][1].numel())
        elif cls == "reduce":
            stat.flops = float(max(1, tensor_args[0][1].numel()))
        elif cls == "collective":         # the operand, as hlo charges it
            stat.comm_bytes = in_b
            stat.group_size = int(node.meta["group_size"])
        ops.append(stat)
        idx = len(ops) - 1
        if inplace or ew_inplace:
            buf = root.get(tensor_args[0][0].name, tensor_args[0][0].name)
            root[node.name] = buf
            writers[buf] = sorted(set(writers.get(buf, [])) | {idx})
        else:
            root[node.name] = node.name
            writers[node.name] = [idx]
    prog = Program(ops=ops, entry=type(gm).__name__, n_partitions=1)
    prog.exact_dtypes = True
    return prog


# ------------------------------------------------------------ memory
def _nbytes(val) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(val)))


def _aliases_operand(node) -> bool:
    """A node that allocates nothing: a view, a collective's wait, one output
    of a multi-output op, or an in-place write (its operand 0's buffer)."""
    if node.target is operator.getitem:
        return True
    if not isinstance(node.target, torch._ops.OpOverload):
        return False
    name = _packet(node.target)
    if name in VIEWS or name in REGION_WRITES:
        return True
    if _is_collective(node.target):
        return name in WAITS
    return (name.endswith("_") and name[:-1] in OPCODES
            and _classify(OPCODES[name[:-1]]) == "elementwise")


def _loop_copies(nodes: list, base: Dict[str, str],
                 last: Dict[str, int]) -> Dict[str, Tuple[int, int]]:
    """The buffers of a loop-aware capture that stand for one an iteration:
    buffer -> (copies, the node index the copies of the other iterations
    are live from).

    * An input of a collapsed loop's stack (its stacked outputs, the
      gradient slices of its stacked parameters): as many copies as the
      stack reads it; the other iterations' are live from the start of the
      body's forward or backward that made it, as unrolled.
    * A buffer that a body's forward makes, or takes as its carry, and
      that the body's backward reads last (what the remat'ed layers save,
      which the reference's scan stacks ``[n, ...]``): the loop's trips,
      live from the buffer's own node."""
    index = {n.name: i for i, n in enumerate(nodes)}
    begins: Dict[tuple, int] = {}       # (loop, backward?) -> first node
    carry: Dict[str, int] = {}          # buffer -> the loop it enters
    made: Dict[str, tuple] = {}         # buffer -> the loops its node ran in
    stacked: Dict[str, int] = {}
    for i, node in enumerate(nodes):
        bwd = node.meta.get("loop_bwd")
        for lid, _ in node.meta.get("loop", ()):
            begins.setdefault((lid, lid == bwd), i)
        if "loop_carry" in node.meta:
            carry[base.get(node.name, node.name)] = node.meta["loop_carry"]
        if base.get(node.name) == node.name and "loop" in node.meta:
            made[node.name] = tuple(lid for lid, _ in node.meta["loop"]
                                    if lid != bwd)
        if node.meta.get("loop_stack") and base.get(node.name) == node.name:
            reads = collections.Counter(
                base.get(a.name, a.name) for a in pytree.tree_leaves(
                    node.args) if isinstance(a, torch.fx.Node))
            for b, k in reads.items():
                stacked[b] = max(stacked.get(b, 1), k)
    out: Dict[str, Tuple[int, int]] = {}
    for b, k in stacked.items():
        maker = nodes[index[b]]
        if k > 1 and "loop" in maker.meta:
            lid = maker.meta["loop"][-1][0]
            out[b] = (k, begins[(lid, maker.meta.get("loop_bwd") == lid)])
    for b, j in last.items():
        lid = nodes[j].meta.get("loop_bwd")
        if lid is not None and b not in out and (
                carry.get(b) == lid or lid in made.get(b, ())):
            out[b] = (dict(nodes[j].meta["loop"])[lid], index[b])
    return out


def memory_analysis(gm: torch.fx.GraphModule, donated=None,
                    top: int = 0) -> Dict[str, Any]:
    """One rank's memory for a captured graph, with the reference's keys
    (``repro.core.simulate`` reads them from XLA's ``memory_analysis``):

    * ``argument_bytes``: the placeholders' bytes (each rank's shards);
    * ``output_bytes``: the returned tensors' bytes, each once;
    * ``temp_bytes``: the peak, in the graph's order, of the live
      intermediates that are neither: a tensor lives from its node to the
      last node that reads it or a view of it (a view keeps its base alive
      and allocates nothing, nor does an in-place write, a collective's
      wait or an output of a multi-output op; one op's outputs and inputs
      are live together);
    * ``alias_bytes``: the bytes of donated arguments that an output of the
      same shape and dtype replaces (each output replaces one);
    * ``peak_bytes_est`` = argument + output + temp - alias, as the
      reference defines it.

    ``donated`` holds the indices of the donated placeholders; by default
    those whose ``node.meta["donated"]`` is set (``launch.cell.Cell.capture``
    marks the arguments of ``donate_argnums`` so).

    In a loop-aware capture a buffer that the unrolled graph holds once an
    iteration counts that many times (``_loop_copies``); a temporary inside
    one iteration counts once.  With ``top``, ``live_at_peak`` lists the
    ``top`` largest temporaries live at the peak: (node, op, shape, dtype,
    bytes held)."""
    nodes = list(gm.graph.nodes)
    base: Dict[str, str] = {}
    size: Dict[str, float] = {}
    last: Dict[str, int] = {}
    inputs = [n for n in nodes if n.op == "placeholder"]
    if donated is None:
        donated = [i for i, n in enumerate(inputs) if n.meta.get("donated")]
    for i, node in enumerate(nodes):
        if node.op == "output":
            continue
        if node.op == "call_function" and _aliases_operand(node):
            src = node.args[0]
            base[node.name] = base.get(src.name, src.name)
        else:
            base[node.name] = node.name
            size[node.name] = _nbytes(node.meta.get("val"))
        last[base[node.name]] = max(last.get(base[node.name], i), i)
        for a in node.all_input_nodes:
            b = base.get(a.name, a.name)
            last[b] = max(last.get(b, i), i)
    out_node = next(n for n in nodes if n.op == "output")
    returned, seen = [], set()
    for a in out_node.all_input_nodes:
        if a.name not in seen:
            seen.add(a.name)
            returned.append(a)
    out_bufs = {base.get(a.name, a.name) for a in returned}
    args = {n.name for n in inputs}
    index = {n.name: i for i, n in enumerate(nodes)}
    copies = {b: kc for b, kc in _loop_copies(nodes, base, last).items()
              if b not in args and b not in out_bufs}
    early: Dict[int, float] = {}        # the other iterations' copies
    for b, (k, i) in copies.items():
        early[i] = early.get(i, 0.0) + size[b] * (k - 1)
    frees: Dict[int, float] = {}
    temp = peak = 0.0
    at = 0
    for i, node in enumerate(nodes):
        b = node.name
        temp += early.pop(i, 0.0)
        if base.get(b) == b and b not in args and b not in out_bufs:
            temp += size[b]
            frees[last[b]] = frees.get(last[b], 0.0) \
                + size[b] * copies.get(b, (1, i))[0]
        if temp > peak:
            peak, at = temp, i
        temp -= frees.pop(i, 0.0)
    arg_b = sum(_nbytes(n.meta.get("val")) for n in inputs)
    out_b = sum(_nbytes(a.meta.get("val")) for a in returned)
    free_outs = [(tuple(t.shape), t.dtype) for a in returned
                 for t in _tensors(a.meta.get("val"))]
    alias = 0.0
    for j in sorted(donated):
        for t in _tensors(inputs[j].meta.get("val")):
            key = (tuple(t.shape), t.dtype)
            if key in free_outs:
                free_outs.remove(key)
                alias += t.numel() * t.element_size()
    out = {"argument_bytes": arg_b, "output_bytes": out_b,
           "temp_bytes": peak, "alias_bytes": alias,
           "peak_bytes_est": arg_b + out_b + peak - alias}
    if top:
        live = [(size[n.name] * (copies[n.name][0] if index[n.name] <= at
                                 else copies[n.name][0] - 1)
                 if n.name in copies else size[n.name], n)
                for n in nodes if base.get(n.name) == n.name
                and n.name not in args and n.name not in out_bufs
                and last[n.name] >= at and min(
                    index[n.name], copies.get(n.name, (1, at + 1))[1]) <= at]
        out["live_at_peak"] = [
            (n.name, str(n.target), [list(t.shape) for t in
                                     _tensors(n.meta.get("val"))],
             [_dtype(t) for t in _tensors(n.meta.get("val"))], held)
            for held, n in sorted(live, key=lambda x: -x[0])[:top]]
    return out
