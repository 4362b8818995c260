"""Logical-axis sharding: one table maps logical axes -> mesh axes.

Counterpart of ``repro.parallel.sharding`` on torch meshes.  Model code never
names mesh axes.  It annotates parameters and activations with *logical*
axes ('batch', 'heads', 'mlp', ...).  A ``MeshRules`` object, installed as a
context, resolves them against the active mesh, with the reference's two
safety rails:

* **divisibility fallback**: an assignment is dropped (dim left replicated)
  when the dim size is not divisible by the product of assigned mesh axes;
  where a prefix of the assigned axes divides it, the prefix is kept (e.g.
  'pod' alone of ('pod', 'data'));
* **uniqueness**: a mesh axis is used at most once per spec; later dims
  lose a conflicting assignment.

A spec is a tuple with one entry per tensor dim, as the reference's
``PartitionSpec``: ``None``, a mesh axis name, or a tuple of names.  The
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``shape``) or any object with ``axis_names`` and ``devices.shape`` (the
duck-typed meshes of ``core.zoo.mesh_rules_resolver``).

On a ``DeviceMesh`` a spec becomes DTensor placements, one per mesh dim:
``Shard(d)`` where the mesh dim's name is in dim d's entry, else
``Replicate()``.  A dim assigned ('pod', 'data') is sharded pod-major, as
JAX orders it, since 'pod' precedes 'data' on the mesh.  DTensor always
splits a dim in mesh-dim order, so ('model', 'data') (the cache's 'kvseq')
is split data-major where JAX splits it model-major: each rank then holds
another slice, the values are the same.

``lsc``/``lsc_param`` redistribute a DTensor to the resolved placements; on
a plain tensor or outside a rules context they return it as it is.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# --------------------------------------------------------------------------- rules
# Parameter logical axes.  'embed' rides the FSDP axis (ZeRO-3 within a pod);
# tensor-parallel axes ride 'model'.
PARAM_RULES = {
    "embed": ("data",),          # FSDP
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "inner": ("model",),         # mamba d_inner / conv channels
    "ssm_heads": ("model",),
    "experts": ("model",),       # EP (dropped automatically when E % 16 != 0 -> expert-TP via 'mlp')
    "head_dim": ("model",),      # fallback TP when head counts don't divide (qwen32b/whisper/paligemma)
    "state": None,
    "layers": None,
    "kwidth": None,
}

# Activation logical axes.
ACT_RULES = {
    "batch": ("pod", "data"),    # 'pod' silently absent on single-pod meshes
    "seq": None,
    # KV-cache sequence sharding (decode SP): 'model' first — GQA KV-head
    # counts (1/2/8) rarely divide the 16-way tensor axis but 32k/500k
    # sequences always do; 'data' joins when batch is too small to use it
    # (long_500k's batch=1 leaves 'data' free -> 256-way cache sharding).
    "kvseq": ("model", "data"),
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "inner": ("model",),
    "ssm_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    # head_dim is a CONTRACTION dim of the attention score matmul: sharding
    # it turns every score block into a partial-sum all-reduce (measured:
    # whisper prefill_32k 58.9 s collective term).  Activations therefore
    # never shard head_dim; archs whose head counts don't divide the tensor
    # axis fall back to sequence parallelism ('sp_seq'/'rseq', enabled per
    # arch in launch/cell.py).
    "head_dim": None,
    "sp_seq": None,              # attention q/out seq axis, SP fallback
    "rseq": None,                # residual-stream seq axis, SP fallback
    "state": None,
    "frames": None,
    "capacity": None,
    "q_group": None,             # GQA group axis of decode scores (tiny)
    "chunks": None,              # SSD chunk axis
    "layers": None,              # stacked-layer axis of cache trees
    "kwidth": None,              # conv-cache kernel-width axis
}


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def mesh_axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def placements_of(spec: Sequence, mesh) -> tuple:
    """DTensor placements, one per mesh dim, of a spec on ``mesh``.  A mesh
    dim of size 1 is ``Replicate()`` whatever the spec: its one shard is the
    whole tensor, and DTensor's view rules refuse to flatten a dim sharded
    so (a 1x1 mesh places every tensor replicated)."""
    out = []
    for name, size in mesh_axis_sizes(mesh).items():
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def local_shape_and_offset(shape, mesh, placements) -> tuple:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed so on ``mesh``, as DTensor splits it (``torch.chunk``
    along each sharded dim, in mesh-dim order), in Python integers: torch's
    own helper builds index tensors, which a capture over fake tensors
    cannot read back."""
    local, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for n, c, pl in zip(mesh.shape, coord, placements):
        if not pl.is_shard():
            continue
        d = pl.dim % len(shape)
        chunk = -(-local[d] // n)
        start = min(c * chunk, local[d])
        size = min(local[d], start + chunk) - start
        off[d] += start
        local[d] = size
    return tuple(local), tuple(off)


def shard_shape(shape, placements, sizes) -> tuple:
    """A rank's shard of ``shape`` placed so on a mesh of ``sizes`` (one
    per mesh dim), in even splits: the parameter and activation rules
    shard a dim only where its mesh axes divide it."""
    local = list(shape)
    for size, pl in zip(sizes, placements):
        if pl.is_shard():
            local[pl.dim] //= size
    return tuple(local)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    stride where its local tensor is contiguous)."""
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


@dataclass
class MeshRules:
    mesh: object
    param_rules: dict = field(default_factory=lambda: dict(PARAM_RULES))
    act_rules: dict = field(default_factory=lambda: dict(ACT_RULES))
    # mesh dims over which ``core.aten.grad_in_placements`` leaves a
    # parameter's gradient unreduced (the trainer's int8 cross-pod
    # compression syncs 'pod' itself)
    keep_grad_dims: tuple = ()

    def _axis_size(self, name: str) -> int:
        return mesh_axis_sizes(self.mesh).get(name, 0)

    def _resolve(self, rules: dict, axes: Sequence[Optional[str]],
                 shape) -> tuple:
        used: set[str] = set()
        out = []
        for i, ax in enumerate(axes):
            assignment: Optional[tuple] = None
            if ax is not None:
                want = rules.get(ax)
                if want:
                    picked = []
                    prod = 1
                    for m in want:
                        sz = self._axis_size(m)
                        if sz and m not in used:
                            picked.append(m)
                            prod *= sz
                    if picked and shape is not None and shape[i] % prod == 0 \
                            and shape[i] > 0:
                        assignment = tuple(picked)
                        used.update(picked)
                    elif picked and shape is not None:
                        # try a prefix of the requested axes (e.g. drop 'pod')
                        for j in range(len(picked) - 1, 0, -1):
                            sub = picked[:j]
                            p = 1
                            for m in sub:
                                p *= self._axis_size(m)
                            if shape[i] % p == 0:
                                assignment = tuple(sub)
                                used.update(sub)
                                break
            if assignment is None:
                out.append(None)
            elif len(assignment) == 1:
                out.append(assignment[0])
            else:
                out.append(assignment)
        return tuple(out)

    def param_spec(self, axes, shape) -> tuple:
        return self._resolve(self.param_rules, axes, shape)

    def act_spec(self, axes, shape) -> tuple:
        return self._resolve(self.act_rules, axes, shape)

    def param_placements(self, axes, shape) -> tuple:
        return placements_of(self.param_spec(axes, shape), self.mesh)

    def act_placements(self, axes, shape) -> tuple:
        return placements_of(self.act_spec(axes, shape), self.mesh)


# --------------------------------------------------------------------- context
_STATE = threading.local()


def current_rules() -> Optional[MeshRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    """Installs ``rules`` for ``lsc``; with rules, plain tensors that meet
    DTensors inside the context count as replicated (the positions, masks
    and constants the models make on the fly)."""
    prev = current_rules()
    _STATE.rules = rules
    try:
        if rules is None:
            yield rules
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication,
            )
            with implicit_replication():
                yield rules
    finally:
        _STATE.rules = prev


def full_value(x):
    """A DTensor's whole value as a plain tensor (gathered from its
    shards); anything else as it is."""
    full = getattr(x, "full_tensor", None)
    return full() if full is not None else x


def _constrain(x, placements):
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def lsc(x, *axes):
    """Logical sharding constraint (activation rules); no-op outside a
    MeshRules context or on a plain tensor."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    return _constrain(x, rules.act_placements(axes, x.shape))


def lsc_param(x, *axes):
    """Logical sharding constraint under the PARAMETER rules (FSDP layout):
    pins per-layer weights, and through the backward their cotangents, to
    the FSDP shard."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    return _constrain(x, rules.param_placements(axes, x.shape))


# ------------------------------------------------- products on local shards
def _einsum_letters(ins, out, xs, mesh) -> Optional[list]:
    """The letter each mesh dim shards: the first lower-case one that an
    operand (the first DTensor operand first) shards there and the outputs
    hold; None where none does (an operand sharded there on a letter the
    outputs lack is gathered).  None for all where an operand holds a
    partial sum."""
    first = next(i for i, x in enumerate(xs) if isinstance(x, DTensor))
    order = [first] + [i for i in range(len(xs)) if i != first]
    letters = []
    for m in range(mesh.ndim):
        pick = None
        for i in order:
            x = xs[i]
            pl = x.placements[m] if isinstance(x, DTensor) else Replicate()
            if pl.is_partial():
                return None
            if not pl.is_shard():
                continue
            L = ins[i][pl.dim % len(ins[i])]
            if L in out and L.islower():
                pick = L
                break
        letters.append(pick)
    return letters


def local_map(spec: str, fn, *xs):
    """``fn(*xs)`` run on each rank's shards, for a ``fn`` that is local in
    every lower-case letter of ``spec`` ("ij,j->ij": one letter a dim of
    each operand, then of each output) that appears in an output; an
    upper-case letter is a dim ``fn`` reads whole (gathered).

    Each operand is redistributed so that a mesh dim shards the same letter
    in all of them (replicated where an operand lacks it: a broadcast), the
    first DTensor operand's letters first; ``fn`` runs on the local tensors
    and its outputs become DTensors sharded on those letters.  The gradient
    of an operand broadcast over a sharded letter is all-reduced over that
    mesh dim (``sum_grad``).  An operand sharded on a letter no output has
    (a contracted one) is gathered on that mesh dim.  Plain tensors count
    as replicated.  Without a DTensor, or where an operand holds a partial
    sum, this is ``fn(*xs)`` on the operands as they are.  The layout
    decides, never the torch version."""
    if not any(isinstance(x, DTensor) for x in xs):
        return fn(*xs)
    ins, outs = spec.replace(" ", "").split("->")
    ins, outs = ins.split(","), outs.split(",")
    mesh = next(x for x in xs if isinstance(x, DTensor)).device_mesh
    letters = _einsum_letters(ins, "".join(outs), xs, mesh)
    sizes = {}
    for sp, x in zip(ins, xs):
        for L, n in zip(sp, x.shape):
            if sizes.setdefault(L, n) != n:
                letters = None             # a broadcast dim of size 1
    if letters is None:
        return fn(*xs)
    locals_ = []
    for sp, x in zip(ins, xs):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = tuple(Shard(sp.index(L)) if L is not None and L in sp
                     else Replicate() for L in letters)
        local = _constrain(x, want).to_local()
        locals_.append(sum_grad(local, mesh, [
            m for m, L in enumerate(letters) if L is not None and L not in sp]))
    ys = fn(*locals_)
    wrapped = []
    for sp, y in zip(outs, ys if len(outs) > 1 else (ys,)):
        shape = tuple(sizes[L] for L in sp)
        # the global stride in the local result's dim order (an einsum may
        # return a permuted view)
        stride, acc = [0] * len(shape), 1
        for d in sorted(range(len(shape)), key=lambda d: (y.stride(d), d)):
            stride[d] = acc
            acc *= shape[d]
        wrapped.append(DTensor.from_local(
            y, mesh, [Shard(sp.index(L)) if L is not None else Replicate()
                      for L in letters],
            run_check=False, shape=torch.Size(shape), stride=tuple(stride)))
    return tuple(wrapped) if len(outs) > 1 else wrapped[0]


def local_einsum(eq: str, *xs):
    """``torch.einsum(eq, *xs)`` on each rank's shards (``local_map``): the
    output's letters keep their shards, a sharded contracted letter is
    gathered.

    DTensor's einsum flattens the batch letters into one ``bmm`` dim, and
    torch 2.11 refuses to flatten dims of which a later one is sharded (a
    batch on 'data' beside heads on 'model', as the SSD scan's products
    have); 2.13 makes it a strided shard (and gathers it piece by piece)."""
    if any(isinstance(x, DTensor) for x in xs):
        ins, out = eq.replace(" ", "").split("->")
        ins = ins.split(",")
        mesh = next(x for x in xs if isinstance(x, DTensor)).device_mesh
        letters = _einsum_letters(ins, out, xs, mesh) or []
        for m, L in enumerate(letters):
            if L is None and any(
                    isinstance(x, DTensor) and x.placements[m].is_shard()
                    for x in xs):
                # only a contracted letter is sharded there: DTensor's
                # einsum sums partial products, where gathering would move
                # the operands whole
                return torch.einsum(eq, *xs)
    return local_map(eq, lambda *a: torch.einsum(eq, *a), *xs)


def all_reduce(x: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """A plain tensor all-reduced (``op``: "sum", "max", ...) over each mesh
    dim in ``dims``, one functional collective a dim; not differentiable."""
    import torch.distributed._functional_collectives as funcol
    for m in dims:
        x = funcol.all_reduce(x.contiguous(), op, (mesh, m))
        if isinstance(x, funcol.AsyncCollectiveTensor):
            x = x.wait()
    return x


class _SumGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over mesh dims (all-reduced)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.mesh, ctx.dims), None, None


class _SumReplicated(torch.autograd.Function):
    """The sum over mesh dims of each rank's part, held by every rank; the
    gradient passes through as it is, since each rank's copy of the sum
    stands for the one value whose gradient every rank receives."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return all_reduce(x, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_replicated(local: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``local`` summed over the mesh dims ``dims`` (all-reduced), the
    result replicated there; its gradient reaches each rank's part
    unreduced (the forward's reduction already counted every part once)."""
    if not dims:
        return local
    return _SumReplicated.apply(local, mesh, tuple(dims))


def sum_grad(local: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``local``, a rank's copy of a tensor replicated over the mesh dims
    ``dims`` that each rank reads for other elements (a broadcast operand
    of a sharded product): its gradient is the sum of the ranks', so the
    backward all-reduces it there and it stays replicated.  (A partial-sum
    gradient placement instead meets sharded gradients of the same tensor,
    which torch 2.11's DTensor cannot add.)"""
    if not dims or not local.requires_grad:
        return local
    return _SumGrad.apply(local, mesh, tuple(dims))


def matmul(x, w):
    """``x @ w`` for ``x`` (..., K) and a weight ``w`` (K, N).  On a mesh
    where ``x`` shards a dim after its first among those the product
    flattens (the sequence-parallel residual: batch on 'data', sequence on
    'model'), the product runs on each rank's rows (``local_einsum``:
    ``w`` gathered where ``x`` shards its rows, kept sharded on N where
    ``x`` is replicated): torch 2.11 refuses that flatten."""
    if isinstance(x, DTensor) and x.ndim > 2 and any(
            p.is_shard() and 0 < p.dim % x.ndim < x.ndim - 1
            for p in x.placements):
        rows = "abcdefghij"[:x.ndim - 1]
        return local_einsum(f"{rows}k,kn->{rows}n", x, w)
    return x @ w


# ------------------------------------------- strategies older torch lacks
def _pointwise_strategy(n_tensors: int, skip):
    """A register_sharding function for an op whose first ``n_tensors``
    arguments are tensors of the output's shape: replicated, or sharded
    alike on any dim not in ``skip(args, ndim)``; never partial (the ops
    are not linear)."""
    def strategy(*args):
        ndim = len(args[0].shape)
        rest = [None] * (len(args) - n_tensors)
        out = [([Replicate()], [Replicate()] * n_tensors + rest)]
        for d in range(ndim):
            if d not in skip(args, ndim):
                out.append(([Shard(d)], [Shard(d)] * n_tensors + rest))
        return out

    return strategy


def _padded_dims(args, ndim: int) -> set:
    """The dims ``constant_pad_nd(x, pad, value)`` pads: ``pad`` holds
    (before, after) pairs from the last dim backwards."""
    pad = args[1]
    return {ndim - 1 - i for i in range(len(pad) // 2)
            if pad[2 * i] or pad[2 * i + 1]}


def register_missing_strategies(force: bool = False) -> list:
    """Registers DTensor sharding strategies for the ops the models run
    whose strategy torch 2.11 lacks (``flip``, from the backward of
    ``cumsum``; ``softplus`` and its backward, Mamba2's dt) and returns
    their names; a torch that has one keeps its own unless ``force`` (the
    gloo mesh tests run on a newer torch than the card's and force them,
    so that these strategies meet Shard placements there too).
    ``constant_pad_nd`` (the attention's and the causal convolution's
    padding) is registered on every torch: torch 2.11's strategy gives its
    output one placement on a 2-D mesh, which the next view refuses.  A
    registered strategy takes the op out of torch's other tables (newer
    torch looks up single-dim strategies first), and the propagation cache
    is cleared.  Each strategy's cache key covers every argument but the
    first, so ``flip``'s dims and the pad widths are part of it."""
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten
    sp = DTensor._op_dispatcher.sharding_propagator
    others = [getattr(sp, n) for n in ("op_to_rules",
                                        "op_single_dim_strategy_funcs")
              if hasattr(sp, n)]
    tables = [sp.op_strategy_funcs, *others]
    no_skip = lambda args, ndim: ()  # noqa: E731
    flipped = lambda args, ndim: {d % ndim for d in args[1]}  # noqa: E731
    always = [(aten.constant_pad_nd.default,
               _pointwise_strategy(1, _padded_dims))]
    wanted = [(aten.flip.default, _pointwise_strategy(1, flipped)),
              (aten.softplus.default, _pointwise_strategy(1, no_skip)),
              (aten.softplus_backward.default,
               _pointwise_strategy(2, no_skip))]
    done = []
    for op, fn in always + wanted:
        if (op, fn) in always or force or not any(op in t for t in tables):
            register_sharding(op)(fn)
            sp.op_to_schema_info[op] = RuntimeSchemaInfo(1,
                                                         needs_pytree=True)
            for t in others:
                t.pop(op, None)
            done.append(str(op))
    clear = getattr(sp.propagate_op_sharding, "cache_clear", None)
    if clear is not None:
        clear()
    return done


register_missing_strategies()


def make_rules(mesh, overrides: Optional[dict] = None,
               act_overrides: Optional[dict] = None) -> MeshRules:
    r = MeshRules(mesh)
    if overrides:
        r.param_rules.update(overrides)
    if act_overrides:
        r.act_rules.update(act_overrides)
    return r
