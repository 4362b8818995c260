"""Optimizers: AdamW and Adafactor, with their state in f32.

Counterpart of ``repro.train.optimizer``.  State trees mirror the parameter
tree leaf for leaf.  Pure-functional, as in the reference:
``init(params) -> state``, ``update(grads, state, params, lr) -> (new_params,
new_state)``; nothing is updated in place.  The state is kept in
``OptConfig.state_dtype`` (f32) and the parameters are updated in their own
dtype, which ``torch.optim.AdamW`` (state in the parameter's dtype) would
not do for bf16 parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from ..models import params as pr
from ..parallel.sharding import local_map


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"           # adamw | adafactor
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    min_dim_size_to_factor: int = 128
    state_dtype: Any = torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(x.float().square().sum() for x in pr.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` so that their global norm is at most ``max_norm``.
    Returns (clipped grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return pr.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _step_tensor(like_tree) -> torch.Tensor:
    leaf = pr.leaves(like_tree)[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


# ------------------------------------------------------------------- AdamW
class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adamw_init(params, cfg: OptConfig) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,  # noqa: E731
                                  device=p.device)
    return AdamWState(step=_step_tensor(params),
                      mu=pr.tree_map(zeros, params),
                      nu=pr.tree_map(zeros, params))


def adamw_update(grads, state: AdamWState, params, lr, cfg: OptConfig):
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    sd = cfg.state_dtype

    def upd(p, g, m, v):
        gf = g.to(sd)
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf.square()
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + cfg.eps)
        delta = delta + cfg.weight_decay * p.to(sd)
        p2 = p.to(sd) - lr * delta
        return p2.to(p.dtype), m2, v2

    out = pr.tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: pr.tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2))


# --------------------------------------------------------------- Adafactor
class AdafactorState(NamedTuple):
    step: torch.Tensor
    # per leaf: (vr, vc) factored, or v full; the unused ones are (1,) zeros
    vr: Any
    vc: Any
    v: Any


def _factored(shape, cfg: OptConfig) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_size_to_factor
            and shape[-2] >= cfg.min_dim_size_to_factor)


def adafactor_init(params, cfg: OptConfig) -> AdafactorState:
    def zeros(p, shape):
        return torch.zeros(shape, dtype=cfg.state_dtype, device=p.device)

    def vr_leaf(p):
        return zeros(p, p.shape[:-1] if _factored(p.shape, cfg) else (1,))

    def vc_leaf(p):
        return zeros(p, p.shape[:-2] + p.shape[-1:]
                     if _factored(p.shape, cfg) else (1,))

    def v_leaf(p):
        return zeros(p, (1,) if _factored(p.shape, cfg) else p.shape)

    return AdafactorState(step=_step_tensor(params),
                          vr=pr.tree_map(vr_leaf, params),
                          vc=pr.tree_map(vc_leaf, params),
                          v=pr.tree_map(v_leaf, params))


def _sharded_like(x, g, dim: int):
    """``x``, a reduction of ``g`` over ``dim``, sharded as ``g`` shards
    its other dims (a DTensor ``g``; else ``x`` as it is), so that the
    factored second moment's outer product (``_outer``) runs on ``g``'s
    shard, as the reference's partitioner keeps it in the gradient's
    sharding."""
    if not hasattr(g, "placements"):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= g.ndim
    want = tuple(Shard(pl.dim - (pl.dim > dim))
                 if pl.is_shard() and pl.dim != dim else Replicate()
                 for pl in g.placements)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _outer(r, c):
    """``r[..., None] * c[..., None, :]``, on each rank's shards on a mesh
    (``local_map``): DTensor takes a broadcast product's layout from one
    operand, gathering the other, which makes it whole on that mesh dim
    (nemotron-4-340b's MLP: (96, 1152, 73728) f32 a rank where the
    gradient's shard is (96, 1152, 4608))."""
    b = "abcdefgh"[:r.ndim - 1]
    return local_map(f"{b}x,{b}y->{b}xy",
                     lambda r, c: r[..., None] * c[..., None, :], r, c)


def adafactor_update(grads, state: AdafactorState, params, lr, cfg: OptConfig):
    step = state.step + 1
    beta = 1.0 - step.float() ** (-cfg.decay_rate)
    sd = cfg.state_dtype

    def upd(p, g, vr, vc, v):
        gf = g.to(sd)
        g2 = gf.square() + 1e-30
        if _factored(p.shape, cfg):
            vr2 = _sharded_like(beta * vr + (1 - beta) * g2.mean(dim=-1),
                                g, -1)
            vc2 = _sharded_like(beta * vc + (1 - beta) * g2.mean(dim=-2),
                                g, -2)
            denom = (_outer(vr2, vc2)
                     / torch.clamp(vr2.mean(dim=-1, keepdim=True)[..., None],
                                   min=1e-30))
            update = gf * torch.rsqrt(denom + cfg.eps)
            v2 = v
        else:
            v2 = beta * v + (1 - beta) * g2
            update = gf * torch.rsqrt(v2 + cfg.eps)
            vr2, vc2 = vr, vc
        # update clipping (RMS <= 1) as in the adafactor paper
        rms = torch.sqrt(update.square().mean() + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        p2 = (p.to(sd) - lr * update
              - lr * cfg.weight_decay * p.to(sd))
        return p2.to(p.dtype), vr2, vc2, v2

    out = pr.tree_map(upd, params, grads, state.vr, state.vc, state.v)
    pick = lambda i: pr.tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), AdafactorState(step=step, vr=pick(1), vc=pick(2),
                                   v=pick(3))


# ------------------------------------------------------------------ facade
def make_optimizer(name: str, cfg: Optional[OptConfig] = None):
    """(init, update, cfg) for ``name`` ("adamw" or "adafactor")."""
    cfg = cfg or OptConfig(name=name)
    if name == "adamw":
        return (lambda p: adamw_init(p, cfg),
                lambda g, s, p, lr: adamw_update(g, s, p, lr, cfg), cfg)
    if name == "adafactor":
        return (lambda p: adafactor_init(p, cfg),
                lambda g, s, p, lr: adafactor_update(g, s, p, lr, cfg), cfg)
    raise ValueError(f"unknown optimizer {name}")


def state_spec_tree(name: str, param_specs, cfg: Optional[OptConfig] = None):
    """Optimizer-state tree of P-leaves (shapes + logical axes) derived from
    the parameter spec tree: the state shards exactly like its parameter
    (ZeRO-3).  The trainer's optimizer placements come from it."""
    P = pr.P
    cfg = cfg or OptConfig(name=name)
    scalar = P((), (), "zeros")
    if name == "adamw":
        mirror = pr.tree_map(lambda p: P(p.shape, p.axes, "zeros"),
                             param_specs)
        return AdamWState(step=scalar, mu=mirror, nu=mirror)
    if name == "adafactor":
        def vr(p):
            if _factored(p.shape, cfg):
                return P(p.shape[:-1], p.axes[:-1], "zeros")
            return P((1,), (None,), "zeros")

        def vc(p):
            if _factored(p.shape, cfg):
                return P(p.shape[:-2] + p.shape[-1:],
                         p.axes[:-2] + p.axes[-1:], "zeros")
            return P((1,), (None,), "zeros")

        def v(p):
            if _factored(p.shape, cfg):
                return P((1,), (None,), "zeros")
            return P(p.shape, p.axes, "zeros")

        return AdafactorState(step=scalar, vr=pr.tree_map(vr, param_specs),
                              vc=pr.tree_map(vc, param_specs),
                              v=pr.tree_map(v, param_specs))
    raise ValueError(f"unknown optimizer {name}")
