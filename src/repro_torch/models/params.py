"""Parameter-tree machinery: declare shapes + logical axes once, then derive
initialized trees and sizes from the same declaration.

Trees are nested dicts whose leaves are ``P`` specs (or, once initialized,
tensors).  ``init`` draws from an explicit ``torch.Generator``; its numbers
differ from ``jax.random``'s for the same seed, so tests hand both packages
one numpy tree instead (``models.convert``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch


@dataclass(frozen=True)
class P:
    """One parameter leaf: shape + logical axes + init recipe."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | embed | conv | a_log | dt_bias
    scale: float = 1.0         # fan-in style scale override (0 -> auto)
    dtype: Optional[str] = None  # leaf dtype override (int8 KV caches etc.)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_leaf(x) -> bool:
    return not isinstance(x, dict)


def tree_map(f: Callable, tree, *rest):
    """Map ``f`` over the leaves of ``tree`` (and the same leaves of ``rest``)."""
    if is_leaf(tree):
        return f(tree, *rest)
    for r in rest:
        if not isinstance(r, dict) or r.keys() != tree.keys():
            raise ValueError(f"tree structures differ: {sorted(tree)} vs "
                             f"{sorted(r) if isinstance(r, dict) else r!r}")
    return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in tree}


def leaves(tree) -> list:
    if is_leaf(tree):
        return [tree]
    return [x for k in tree for x in leaves(tree[k])]


def _truncated_normal(shape, gen: torch.Generator, lo: float = -2.0,
                      hi: float = 2.0) -> torch.Tensor:
    """Standard normal truncated to [lo, hi], by inverting the CDF."""
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))  # noqa: E731
    a, b = cdf(lo), cdf(hi)
    x = torch.rand(shape, generator=gen, device=gen.device)   # in place below:
    x.mul_(b - a).add_(a).mul_(2.0).sub_(1.0).erfinv_()     # leaves are GBs
    return x.mul_(math.sqrt(2.0)).clamp_(lo, hi)


def leaf_dtype(p: P, dtype: torch.dtype) -> torch.dtype:
    """The leaf's own dtype (``p.dtype``, a torch dtype name such as
    ``"int8"``), else ``dtype``."""
    return getattr(torch, p.dtype) if p.dtype else dtype


def _init_leaf(gen: torch.Generator, p: P, dtype: torch.dtype) -> torch.Tensor:
    dev = gen.device
    dtype = leaf_dtype(p, dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=dev)
    if p.init == "embed":
        return (torch.randn(p.shape, generator=gen, device=dev) * 0.02).to(dtype)
    if p.init == "a_log":       # mamba2: A ~ U[1, 16), stored as log A
        u = torch.rand(p.shape, generator=gen, device=dev)
        return torch.log(u.mul_(15.0).add_(1.0)).to(dtype)
    if p.init == "dt_bias":     # softplus^-1 of dt, log-uniform in [1e-3, 1e-1]
        u = torch.rand(p.shape, generator=gen, device=dev)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(u.mul_(hi - lo).add_(lo))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if p.init == "conv":        # fan-in is the kernel width, shape[-1]
        fan_in = p.shape[-1]
    elif p.init == "normal":
        # Fan-in comes from one layer's shape: the reference takes it from
        # the stacked leaf, whose leading axis is the layer count (std
        # 1/sqrt(28) for every chatglm3-6b matrix, which drives the random
        # full-width model into saturation).
        shape = p.shape[1:] if p.axes[:1] == ("layers",) else p.shape
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
    else:
        raise ValueError(f"unknown init {p.init!r}")
    # truncated normal, fan-in scaled
    std = p.scale / math.sqrt(max(fan_in, 1))
    return _truncated_normal(p.shape, gen).mul_(std).to(dtype)


def init(tree, gen: torch.Generator, dtype: torch.dtype = torch.float32):
    """Initialized tensors on ``gen.device``, drawn in tree order from ``gen``;
    in ``dtype`` unless the leaf names its own."""
    return tree_map(lambda p: _init_leaf(gen, p, dtype), tree)


def abstract(tree, dtype: torch.dtype = torch.bfloat16):
    """The tree as ``meta`` tensors (shape and dtype, no storage), each leaf
    in its own dtype, else ``dtype``: the reference's ``ShapeDtypeStruct``
    tree."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=leaf_dtype(p, dtype),
                                          device="meta"), tree)


def shardings(tree, rules):
    """Placements tree from a spec tree + ``parallel.sharding.MeshRules``:
    each leaf the DTensor placements (one per mesh dim) of the reference's
    ``NamedSharding``."""
    return tree_map(lambda p: rules.param_placements(p.axes, p.shape), tree)


def stacked_shards(tree, rules) -> dict:
    """{"a/b": (global shape, a rank's shard shape)} of the stacked leaves
    (a leading 'layers' axis) of a spec tree under ``rules``."""
    from ..parallel.sharding import mesh_axis_sizes, shard_shape
    sizes = tuple(mesh_axis_sizes(rules.mesh).values())
    out = {}

    def walk(t, prefix):
        if not is_leaf(t):
            for k in t:
                walk(t[k], f"{prefix}{k}/")
        elif t.axes and t.axes[0] == "layers":
            out[prefix[:-1]] = (tuple(t.shape), shard_shape(
                t.shape, rules.param_placements(t.axes, t.shape), sizes))
    walk(tree, "")
    return out


def distribute(tree, placements, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with the placements
    of the same leaf of ``placements`` (a ``shardings`` tree).  Every rank
    holds the whole tree and keeps its own shard: no data moves between
    ranks, and a replicated leaf keeps the tensor's storage."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, pl: distribute_tensor(
        t, mesh, list(pl), src_data_rank=None), tree, placements)


def count(tree) -> int:
    return sum(math.prod(p.shape) for p in leaves(tree))


def bytes_of(tree, dtype: torch.dtype = torch.bfloat16) -> int:
    return sum(math.prod(p.shape) * leaf_dtype(p, dtype).itemsize
               for p in leaves(tree))
