"""Shared layers: norms (plain and gated), rotary embeddings, MLP variants,
embeddings."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from ..configs.base import ModelConfig
from ..parallel.sharding import local_einsum, lsc, matmul
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
    log-sum-exp; labels are always < ``vocab_size``."""
    # on a mesh the vocabulary is gathered first: DTensor's gather from a
    # vocab-sharded tensor (a masked partial) fails on these 3-d indices
    lg = lsc(logits[:, :-1].float(), "batch", "rseq", None)
    tg = tokens[:, 1:]
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tg[..., None].long())[..., 0]
    return (lse - picked).mean()
