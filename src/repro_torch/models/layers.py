"""Shared layers: norms (plain and gated), rotary embeddings, MLP variants,
embeddings."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..parallel.sharding import (
    all_reduce,
    local_einsum,
    local_shape_and_offset,
    lsc,
    matmul,
    sum_replicated,
)
from .params import P


# ------------------------------------------------------------------- norms
def norm_params(cfg: ModelConfig) -> dict:
    if cfg.norm_kind == "layernorm":
        return {"scale": P((cfg.d_model,), ("embed",), "ones"),
                "bias": P((cfg.d_model,), ("embed",), "zeros")}
    return {"scale": P((cfg.d_model,), ("embed",), "ones")}


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm when ``p`` has a bias; computed in f32."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_norm_gated(x: torch.Tensor, scale: torch.Tensor, gate: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Mamba2 output norm: RMSNorm(x * silu(gate)), computed in f32."""
    xf = x.float() * F.silu(gate.float())
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ------------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, fraction: float, theta: float,
               device: Optional[torch.device] = None) -> Optional[torch.Tensor]:
    rot = int(head_dim * fraction)
    rot -= rot % 2
    if rot == 0:
        return None
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).

    Rotates interleaved pairs (0::2, 1::2) of the first ``rot`` dims.
    """
    inv = rope_freqs(x.shape[-1], fraction, theta, x.device)
    if inv is None:
        return x
    rot = inv.shape[0] * 2
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., None].float() * inv          # (..., seq, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1 = xr[..., 0::2].float()
    x2 = xr[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1)


# ---------------------------------------------------------------------- MLP
def mlp_params(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "wi_gate": P((d, f), ("embed", "mlp")),
            "wi_up": P((d, f), ("embed", "mlp")),
            "wo": P((f, d), ("mlp", "embed")),
        }
    return {"wi": P((d, f), ("embed", "mlp")), "wo": P((f, d), ("mlp", "embed"))}


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; so does this port.
    if kind in ("swiglu", "geglu"):
        g = matmul(x, p["wi_gate"])
        u = matmul(x, p["wi_up"])
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = matmul(x, p["wi"])
        if kind == "sq_relu":
            h = F.relu(h).square()
        else:
            h = F.gelu(h, approximate="tanh")
    h = lsc(h, "batch", "rseq", "mlp")
    return matmul(h, p["wo"])


# ----------------------------------------------------------------- embedding
def embed_params(cfg: ModelConfig) -> dict:
    V, d = cfg.padded_vocab, cfg.d_model
    out = {"table": P((V, d), ("vocab", "embed"), "embed")}
    if not cfg.tie_embeddings:
        out["head"] = P((d, V), ("embed", "vocab"))
    return out


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if isinstance(tokens, DTensor):
        # the table is indexed by the whole batch's tokens: DTensor's rule
        # replicates them (and torch 2.11's refuses a batch sharded on two
        # mesh dims, as ('pod', 'data') shards it)
        mesh = tokens.device_mesh
        tokens = tokens.redistribute(mesh, [Replicate()] * mesh.ndim)
    x = p["table"][tokens]
    if cfg.name.startswith("paligemma"):  # gemma scales embeddings
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return lsc(x, "batch", "rseq", "embed")


def logits_from_hidden(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings and isinstance(x, DTensor):
        # the table's two gradients (the lookup's, the head's) must meet in
        # placements torch 2.11's DTensor can add: the head's is summed
        # over 'data' here (``local_einsum``) instead of left a partial sum
        out = local_einsum("bsd,vd->bsv", x, p["table"])
    else:
        out = matmul(x, p["table"].T if cfg.tie_embeddings else p["head"])
    return lsc(out, "batch", "rseq", "vocab")


# --------------------------------------------------------------------- loss
def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    vocab_size: int) -> torch.Tensor:
    """Mean next-token cross-entropy in f32.  logits: (B,S,Vp) for tokens
    (B,S).  As in the reference, the padded vocabulary entries stay in the
    log-sum-exp; labels are always < ``vocab_size``.

    On a mesh (a DTensor ``logits``) the loss is computed on each rank's
    shard of the logits, in the layout the rules give them
    (``sharded_next_token_loss``), where the reference's partitioner keeps
    its ("batch", "rseq", "vocab") constraint."""
    if isinstance(logits, DTensor):
        return sharded_next_token_loss(logits, tokens)
    lg = logits[:, :-1].float()
    tg = tokens[:, 1:]
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tg[..., None].long())[..., 0]
    return (lse - picked).mean()


class _ShardCrossEntropy(torch.autograd.Function):
    """Cross-entropy of each row of a rank's logits ``lg`` (..., Vl), the
    columns [v0, v0 + Vl) of a vocabulary split over the mesh dims ``dims``:
    the row maximum, the sum of exponentials and the label's logit (from
    the one rank whose columns hold it; a label of -1 is held by none) are
    all-reduced over ``dims``.  The sums of exponentials accumulate in f64,
    so how many ranks split the vocabulary changes the log-sum-exp by one
    rounding at most.  Returns the rows' log-sum-exp minus the label's
    logit, in f32.  The backward writes the rank's columns of softmax -
    one-hot, times the rows' gradient, in ``lg``'s dtype: one buffer of
    the rank's shape."""

    @staticmethod
    def forward(ctx, lg, labels, v0, mesh, dims):
        x = lg.float()
        m = all_reduce(x.amax(dim=-1), "max", mesh, dims)
        se = all_reduce(torch.exp(x - m[..., None]).sum(
            dim=-1, dtype=torch.float64), "sum", mesh, dims)
        lse = torch.log(se.float()) + m
        col = labels - v0
        hit = (col >= 0) & (col < x.shape[-1])
        col = col.clamp(0, x.shape[-1] - 1)
        picked = torch.gather(x, -1, col[..., None])[..., 0]
        picked = all_reduce(torch.where(hit, picked, 0.0), "sum", mesh, dims)
        ctx.save_for_backward(lg, lse, col, hit)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        lg, lse, col, hit = ctx.saved_tensors
        p = torch.exp(lg.float() - lse[..., None]) * g[..., None]
        p = p.scatter_add(-1, col[..., None], -(g * hit)[..., None])
        return p.to(lg.dtype), None, None, None, None


def sharded_next_token_loss(logits: DTensor, tokens) -> DTensor:
    """``next_token_loss`` of a DTensor ``logits``, on local tensors:
    nothing is allocated beyond a rank's share (B / batch shards,
    S / sequence shards, Vp / vocabulary shards) of the logits.

    The mesh dims that shard the logits' batch, sequence (the
    sequence-parallel archs' 'rseq') and vocabulary ('vocab') are read
    from their placements.  Each rank takes its rows' labels from its
    rows of ``tokens`` (the last position's is -1, no label), computes its
    rows' cross-entropy with the vocabulary's reductions over the
    vocabulary's mesh dims (``_ShardCrossEntropy``), and sums the rows with
    a label, divided by the global count B (S - 1); the sums are
    all-reduced over the batch's and sequence's mesh dims.  Returns the
    loss as a replicated DTensor.  Where no mesh dim shards the logits (a
    1x1 mesh), the no-mesh formula runs on the local tensors: its bits."""
    mesh, pls = logits.device_mesh, tuple(logits.placements)
    rep = [Replicate()] * mesh.ndim
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, rep, run_check=False)
    rows = tokens.redistribute(mesh, [
        Shard(0) if p.is_shard(0) else Replicate() for p in pls]).to_local()
    local = logits.to_local()
    if not any(p.is_shard() for p in pls):
        loss = next_token_loss(local, rows, 0)
    else:
        sharding = [[m for m, p in enumerate(pls) if p.is_shard(d)]
                    for d in range(3)]
        (_, Sl, _), (_, s0, v0) = local_shape_and_offset(logits.shape, mesh,
                                                         pls)
        B, S = logits.shape[:2]
        labels = F.pad(rows[:, 1:].long(), (0, 1), value=-1)[:, s0:s0 + Sl]
        ce = _ShardCrossEntropy.apply(local, labels, v0, mesh, sharding[2])
        part = torch.where(labels >= 0, ce, 0.0).sum() / (B * (S - 1))
        loss = sum_replicated(part, mesh, sharding[0] + sharding[1])
    return DTensor.from_local(loss, mesh, rep, run_check=False)
