"""Mixture-of-Experts FFN: sort-based capacity routing in gather/scatter form.

Counterpart of ``repro.models.moe``.  Tokens are routed within groups (one
group a sequence; one global group in decode, S == 1).  In a group each
token's top-k experts are sorted by expert (a stable sort, so a token keeps
its place among the expert's tokens), each assignment's rank within its
expert is its index less the expert's first index (``searchsorted``), and the
first ``C`` assignments of each expert are kept: ``C`` comes from the shapes
(``capacity``), so nothing waits on the device.  Dispatch is a gather of the
kept tokens into an (E, C, d) block, combine a gather of the expert outputs
back, weighted by the gates (0 for a dropped assignment), and an
``index_add_`` into the tokens.  The sharding constraints (``lsc``) sit
where the reference's do; the experts-leading (E, G*C, f) hidden block is
pinned as ('experts', 'batch', 'mlp'), G being outermost in G*C.

``jax.lax.top_k`` breaks ties by the lower index and ``torch.topk``
promises no order among equal values: the two packages route alike where
the router's probabilities differ, as they do for random weights.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..parallel.sharding import local_map, lsc, matmul
from .params import P


def moe_params(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.n_experts
    out = {"router": P((d, E), ("embed", "experts"))}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        out["wi_gate"] = P((E, d, f), ("experts", "embed", "mlp"))
        out["wi_up"] = P((E, d, f), ("experts", "embed", "mlp"))
        out["wo"] = P((E, f, d), ("experts", "mlp", "embed"))
    else:
        out["wi"] = P((E, d, f), ("experts", "embed", "mlp"))
        out["wo"] = P((E, f, d), ("experts", "mlp", "embed"))
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        out["shared_wi_gate"] = P((d, fs), ("embed", "mlp"))
        out["shared_wi_up"] = P((d, fs), ("embed", "mlp"))
        out["shared_wo"] = P((fs, d), ("mlp", "embed"))
    return out


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = math.ceil(tokens_per_group * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 lanes


def route(expert_idx: torch.Tensor, C: int, E: int):
    """Capacity routing of every group at once.  expert_idx: (G, T, k).

    Returns, over the G groups' T*k assignments in expert order,
    ``order`` (the sort's permutation of the token-major assignments),
    ``st`` (each one's token), ``dest`` (its slot e*C + rank in the (E*C)
    dispatch block, or E*C, a trash slot, where it is dropped), ``keep``
    (rank < C) and ``src`` (G, E*C): each slot's token, T for an empty slot.
    """
    G, T, k = expert_idx.shape
    dev = expert_idx.device
    e_flat = expert_idx.reshape(G, T * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    se = torch.gather(e_flat, 1, order)
    st = torch.div(order, k, rounding_mode="floor")  # repeat(arange(T), k)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    start = torch.searchsorted(se, experts, side="left")
    rank = torch.arange(T * k, device=dev) - torch.gather(start, 1, se)
    keep = rank < C
    dest = torch.where(keep, se * C + rank.clamp(max=C - 1), E * C)
    src = torch.full((G, E * C + 1), T, dtype=torch.long, device=dev)
    src.scatter_(1, dest, st)
    return order, st, dest, keep, src[:, :E * C]


def _dispatch(xpad: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Each dispatch slot's token row: (G, T+1, d) by (G, E*C) -> (G, E*C,
    d).  Group by group, so on a mesh each rank dispatches its own groups
    (``local_map``)."""
    return torch.gather(xpad, 1, src[..., None].expand(-1, -1,
                                                       xpad.shape[-1]))


def _combine(ys_flat, dest, gate_vals, order, keep, st) -> torch.Tensor:
    """Each assignment's expert output (0 where dropped), weighted by its
    gate, added into its token: (G, T, d).  Group by group, as
    ``_dispatch``."""
    G, T, k = gate_vals.shape
    d = ys_flat.shape[-1]
    rows = torch.gather(ys_flat, 1, dest[..., None].expand(-1, -1, d))
    w = torch.gather(gate_vals.reshape(G, T * k), 1, order) * keep
    rows = rows * w[..., None].to(ys_flat.dtype)
    tok = (st + T * torch.arange(G, device=st.device)[:, None]).reshape(-1)
    out = ys_flat.new_zeros(G * T, d).index_add_(0, tok,
                                                 rows.reshape(G * T * k, d))
    return out.reshape(G, T, d)


def _route_groups(expert_idx: torch.Tensor, C: int, E: int):
    """``route`` on a mesh: each rank routes its own groups, whose tokens it
    gathers first (DTensor has no strategy for ``searchsorted``, and the
    routing reads a group's assignments whole).  The results (integers, no
    gradient) stay sharded over the groups as ``expert_idx`` is."""
    if not isinstance(expert_idx, DTensor):
        return route(expert_idx, C, E)
    mesh = expert_idx.device_mesh
    pl = [Shard(0) if p.is_shard(0) else Replicate()
          for p in expert_idx.placements]
    local = expert_idx.redistribute(mesh, pl).to_local()
    G, T, k = expert_idx.shape
    shapes = [(G, T * k)] * 4 + [(G, E * C)]
    return tuple(
        DTensor.from_local(t, mesh, pl, run_check=False,
                           shape=torch.Size(shp), stride=(shp[1], 1))
        for t, shp in zip(route(local, C, E), shapes))


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig, train: bool,
              dropped: Optional[list] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  Groups = sequences (train/prefill)
    or one global group (decode, S == 1).  ``dropped``, where given, gets
    one 0-d device tensor appended: the assignments over capacity (read it
    after the call; appending does not wait for the device)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    xg = x.reshape(1, B, d) if S == 1 else x          # (G, T, d)
    G, T, _ = xg.shape
    C = capacity(T, cfg)

    logits = matmul(xg, p["router"].to(xg.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)   # (G, T, k)
    if k > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))
    chosen = (expert_idx[..., None] == torch.arange(E, device=x.device)) \
        .any(dim=2)                                        # (G, T, E)
    fe = chosen.float().mean(dim=(0, 1))
    aux = E * (me * fe).sum() * m.aux_loss_coef

    order, st, dest, keep, src = _route_groups(expert_idx, C, E)
    if dropped is not None:
        dropped.append((~keep).sum())
    xpad = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    dispatched = local_map("gTd,gs->gsd", _dispatch, xpad, src)
    dispatched = lsc(dispatched.reshape(G, E, C, d), "batch", "experts",
                     "capacity", "embed")

    # expert FFN, experts leading: (E, G*C, d) x (E, d, f)
    xe = dispatched.transpose(0, 1).reshape(E, G * C, d)
    if "wi_gate" in p:
        g = torch.bmm(xe, p["wi_gate"])
        u = torch.bmm(xe, p["wi_up"])
        act = F.silu(g) if cfg.mlp_kind == "swiglu" \
            else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = torch.bmm(xe, p["wi"])
        h = F.relu(h).square() if cfg.mlp_kind == "sq_relu" \
            else F.gelu(h, approximate="tanh")
    h = lsc(h, "experts", "batch", "mlp")      # (E, G*C, f): G outermost
    ys = torch.bmm(h, p["wo"]).reshape(E, G, C, d).transpose(0, 1)
    ys = lsc(ys, "batch", "experts", "capacity", "embed")

    ys_flat = torch.cat([ys.reshape(G, E * C, d), ys.new_zeros(G, 1, d)], 1)
    out = local_map("gSd,gA,gTk,gA,gA,gA->gTd", _combine, ys_flat, dest,
                    gate_vals, order, keep, st)

    if m.n_shared_experts:
        g = matmul(xg, p["shared_wi_gate"])
        u = matmul(xg, p["shared_wi_up"])
        act = F.silu(g) if cfg.mlp_kind == "swiglu" \
            else F.gelu(g, approximate="tanh")
        out = out + matmul(act * u, p["shared_wo"])

    return out.reshape(B, S, d), aux
