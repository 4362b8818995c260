"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060].

Counterpart of ``repro.models.ssm``.  Prefill uses the chunked SSD algorithm
(quadratic within Q-length chunks, linear state passing across chunks);
decode uses the O(1) recurrence.  ``apply_mamba`` takes ``impl``:

* ``"chunked"`` — ``ssd_chunked`` in plain PyTorch, the counterpart of the
  reference's ``"jnp"`` path (and, like it, M rounded to x's dtype);
* ``"kernel"`` — ``kernels.ops.ssd_scan``, the counterpart of the
  reference's ``"pallas"`` path, with dt cast to x's dtype as there: the
  intra-chunk kernel K4 on CUDA tensors, its plain version on CPU tensors.
  On a mesh its custom ops take DTensor sharding strategies (batch, and
  heads), where the reference's ``ssd_pallas_sharded`` wraps the kernel
  in a ``shard_map``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import aten
from ..device import resolve
from ..kernels import ops as kops
from ..parallel.sharding import local_einsum, local_map, lsc, matmul
from .layers import rms_norm_gated
from .params import P

SSD_IMPLS = ("chunked", "kernel")


def mamba_params(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gn = s.n_groups * s.d_state
    return {
        "wz": P((d, di), ("embed", "inner")),
        "wx": P((d, di), ("embed", "inner")),
        "wB": P((d, gn), ("embed", "state")),
        "wC": P((d, gn), ("embed", "state")),
        "wdt": P((d, nh), ("embed", "ssm_heads")),
        "conv_x_w": P((di, s.d_conv), ("inner", "kwidth"), "conv"),
        "conv_x_b": P((di,), ("inner",), "zeros"),
        "conv_B_w": P((gn, s.d_conv), ("state", "kwidth"), "conv"),
        "conv_B_b": P((gn,), ("state",), "zeros"),
        "conv_C_w": P((gn, s.d_conv), ("state", "kwidth"), "conv"),
        "conv_C_b": P((gn,), ("state",), "zeros"),
        "dt_bias": P((nh,), ("ssm_heads",), "dt_bias"),
        "A_log": P((nh,), ("ssm_heads",), "a_log"),
        "D": P((nh,), ("ssm_heads",), "ones"),
        "norm": P((di,), ("inner",), "ones"),
        "out_proj": P((di, d), ("inner", "embed")),
    }


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  u: (B,S,C), w: (C,K).  Returns (y, new_cache)
    where new_cache holds the last K-1 inputs."""
    S = u.shape[1]
    K = w.shape[1]
    if cache is None:
        up = F.pad(u, (0, 0, K - 1, 0))
    else:
        up = torch.cat([cache.to(u.dtype), u], dim=1)
    y = torch.zeros_like(u)
    for k in range(K):
        y = y + up[:, k:k + S, :] * w[:, k].to(u.dtype)
    y = F.silu(y + b.to(u.dtype))
    return y, up[:, -(K - 1):, :]


def _segsum(cs: torch.Tensor) -> torch.Tensor:
    """cs: (..., Q) inclusive cumsum of dA.  Returns (..., Q, Q) matrix
    T[i, j] = cs[i] - cs[j] for i >= j, -inf otherwise."""
    Q = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=cs.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in plain PyTorch.

    x: (B, L, H, P); dt: (B, L, H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B, L, G, N) with H % G == 0.
    Returns (y (B, L, H, P), final_state (B, H, P, N)), in x's dtype.
    """
    Bsz, L, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // Q
    dtype = x.dtype

    xc = x.reshape(Bsz, nc, Q, H, Pd)
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, G, N)
    Cc = Cm.reshape(Bsz, nc, Q, G, N)

    dA = dtc * A.float()                                  # (B,nc,Q,H)
    cs = torch.cumsum(dA, dim=2)                          # inclusive

    # ---- intra-chunk (quadratic within chunk)
    Lmat = torch.exp(_segsum(cs.transpose(-1, -2)))       # (B,nc,H,Q,Q)
    scores = local_einsum("bcigs,bcjgs->bcgij", Cc.float(), Bc.float())
    scores = scores.repeat_interleave(hpg, dim=2)         # (B,nc,H,Q,Q)
    M = scores * Lmat * dtc.transpose(-1, -2)[..., None, :]
    y_diag = local_einsum("bchij,bcjhp->bcihp", M.to(dtype), xc)

    # ---- per-chunk end states: sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j
    decay_st = torch.exp(cs[:, :, -1:, :] - cs) * dtc     # (B,nc,Q,H)
    Bh = Bc.repeat_interleave(hpg, dim=3)                 # (B,nc,Q,H,N)
    S_c = local_einsum("bcjhn,bcjhp->bchpn",
                       decay_st.to(dtype)[..., None] * Bh.to(dtype), xc)

    # ---- inter-chunk recurrence over nc (linear), in x's dtype
    gamma = torch.exp(cs[:, :, -1, :]).to(dtype)          # (B,nc,H)
    carry = (torch.zeros((Bsz, H, Pd, N), dtype=dtype, device=x.device)
             if initial_state is None else initial_state.to(dtype))
    # on a mesh the loop runs on each rank's shards (elementwise over batch
    # and heads): no DTensor dispatch an op and chunk
    prev_states, carry = local_map("bch,bchpn,bhpn->bchpn,bhpn", _recurrence,
                                   gamma, S_c, carry)

    # ---- inter-chunk contribution: exp(cs_i) * C_i . prev_state
    Ch = Cc.repeat_interleave(hpg, dim=3)                 # (B,nc,Q,H,N)
    y_off = local_einsum("bcihn,bchpn->bcihp", Ch.to(dtype), prev_states)
    y_off = y_off * torch.exp(cs)[..., None].to(dtype)

    y = (y_diag + y_off).reshape(Bsz, Lp, H, Pd)[:, :L]
    return y, carry


def _recurrence(gamma, S_c, carry):
    """The states entering each chunk (B,nc,H,P,N) and the final one.  The
    states entering chunks 1 to nc - 1 come from a ``core.aten.repeat``
    over the chunks but the last (the reference's ``lax.scan``), gamma and
    the chunks' states stacked on their chunk dim; the final state is one
    more step after it.  So each iteration's new state is read (its y), as
    every iteration's is in the reference's scan."""
    nc = S_c.shape[1]

    def step(carry, c, g, s):
        carry = carry * g[:, :, None, None] + s
        return carry, carry

    last, ys = aten.repeat(step, nc - 1, carry,
                           xs=(gamma[:, :-1].movedim(1, 0),
                               S_c[:, :-1].movedim(1, 0)))
    final = last * gamma[:, -1, :, None, None] + S_c[:, -1]
    prev, _ = aten.with_carry_grad(aten.stack([carry, *ys], dim=1), last)
    return prev, final


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence, in f32.  state: (B,H,P,N); x: (B,H,P); dt: (B,H);
    Bm, Cm: (B,G,N).  Returns (y (B,H,P) in x's dtype, new_state in state's)."""
    hpg = x.shape[1] // Bm.shape[1]
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                       # (B,H)
    Bh = Bm.repeat_interleave(hpg, dim=1).float()         # (B,H,N)
    Ch = Cm.repeat_interleave(hpg, dim=1).float()
    upd = (dtf[..., None] * Bh)[:, :, None, :] * x.float()[..., None]
    new_state = state.float() * dA[..., None, None] + upd  # (B,H,P,N)
    y = local_einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state.to(state.dtype)


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B,S,G,N) -> (B,S,H,N), head h reading group h // (H/G).  With one
    group this is a stride-0 view, not a copy."""
    Bsz, S, G, N = t.shape
    return t[:, :, :, None].expand(Bsz, S, G, H // G, N).reshape(Bsz, S, H, N)


def apply_mamba(p: dict, x_in: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: Optional[dict] = None, impl: str = "chunked"):
    """Full Mamba2 mixer.  x_in: (B, S, d).  Returns (out, new_cache).

    ``impl`` is ``"chunked"`` or ``"kernel"`` (see the module docstring).
    Decode (S == 1) writes the new conv windows and state into ``cache`` IN
    PLACE and returns it; the reference returns an updated copy.
    """
    if impl not in SSD_IMPLS:
        raise ValueError(f"unknown SSD impl {impl!r}; use one of {SSD_IMPLS}")
    s = cfg.ssm
    Bsz, S, d = x_in.shape
    di = s.d_inner(d)
    nh = s.n_heads(d)
    G, N, Pd = s.n_groups, s.d_state, s.head_dim

    z = matmul(x_in, p["wz"])
    xr = matmul(x_in, p["wx"])
    Br = matmul(x_in, p["wB"])
    Cr = matmul(x_in, p["wC"])
    dt_raw = matmul(x_in, p["wdt"])
    xr = lsc(xr, "batch", "seq", "inner")

    cx = cache.get("conv_x") if cache else None
    cB = cache.get("conv_B") if cache else None
    cC = cache.get("conv_C") if cache else None
    xr, ncx = causal_conv(xr, p["conv_x_w"], p["conv_x_b"], cx)
    Br, ncB = causal_conv(Br, p["conv_B_w"], p["conv_B_b"], cB)
    Cr, ncC = causal_conv(Cr, p["conv_C_w"], p["conv_C_b"], cC)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    # shard SSD heads on 'model': the (B, nc, H, Q, Q) intra-chunk matrices
    # ride the tensor axis
    xh = lsc(xr.reshape(Bsz, S, nh, Pd), "batch", "seq", "ssm_heads",
             "head_dim")
    dt = lsc(dt, "batch", "seq", "ssm_heads")
    Bm = Br.reshape(Bsz, S, G, N)
    Cm = Cr.reshape(Bsz, S, G, N)

    if mode == "decode":
        if S != 1:
            raise ValueError(f"decode takes one token, not {S}")
        y, new_state = ssd_decode_step(
            cache["state"], xh[:, 0], dt[:, 0].to(x_in.dtype), A, Bm[:, 0],
            Cm[:, 0])
        y = y[:, None]                                    # (B,1,H,P)
        for name, new in (("conv_x", ncx), ("conv_B", ncB), ("conv_C", ncC),
                          ("state", new_state)):
            cache[name].copy_(new)
        new_cache = cache
    else:
        init = cache["state"] if cache else None
        if impl == "kernel":
            y, final_state = kops.ssd_scan(
                xh, dt.to(xh.dtype), A, _heads(Bm, nh), _heads(Cm, nh),
                chunk=s.chunk, initial_state=init)
        else:
            y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk, init)
        new_cache = None
        if mode == "prefill":
            new_cache = {"conv_x": ncx, "conv_B": ncB, "conv_C": ncC,
                         "state": final_state}

    y = y + xh * p["D"].to(y.dtype)[:, None]
    y = y.reshape(Bsz, S, di)
    y = rms_norm_gated(y, p["norm"], z)
    return lsc(matmul(y, p["out_proj"]), "batch", "rseq", "embed"), new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: str | torch.device = "cuda") -> dict:
    """One layer's zero cache: conv windows and SSD state."""
    device = resolve(device)
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gn = s.n_groups * s.d_state
    shapes = {"conv_x": (batch, s.d_conv - 1, di),
              "conv_B": (batch, s.d_conv - 1, gn),
              "conv_C": (batch, s.d_conv - 1, gn),
              "state": (batch, nh, s.head_dim, s.d_state)}
    return {k: torch.zeros(v, dtype=dtype, device=device)
            for k, v in shapes.items()}
