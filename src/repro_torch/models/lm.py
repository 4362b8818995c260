"""The language model, dense family.

Counterpart of ``repro.models.lm``.  ``LM`` builds the parameter-spec tree,
initializes it and provides the entry points:

* ``prefill_fn(params, batch)``         — last-position logits + cache
* ``decode_fn(params, cache, batch)``   — one new token against the cache

Parameters keep the reference's tree (per-layer leaves stacked on a leading
``layers`` axis) and the cache its ``{"k", "v"}`` leaves of shape
(L, B, S, KVH, HD), so both compare leaf for leaf.  ``lax.scan`` over layers
becomes a Python loop over layer views.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve
from . import params as pr
from .attention import attention_block, attn_params
from .layers import (
    apply_mlp,
    apply_norm,
    embed_params,
    embed_tokens,
    logits_from_hidden,
    mlp_params,
    norm_params,
)
from .params import P

# Families not ported yet, with the ROADMAP item that ports each.
_UNPORTED = {
    "moe": "ROADMAP queue 1, the MoE slice (grok-1, llama4-scout)",
    "ssm": "ROADMAP queue 1, the SSM slice (mamba2, kernels K4/K5)",
    "hybrid": "ROADMAP queue 1, the SSM slice (zamba2)",
    "vlm": "ROADMAP queue 1, the VLM and audio slice (paligemma)",
    "audio": "ROADMAP queue 1, the VLM and audio slice (whisper)",
}


def stack_specs(tree, n: int):
    """Prepend a 'layers' axis to every leaf of a layer spec tree."""
    return pr.tree_map(
        lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale), tree)


class LM:
    """A language model of the dense family: specs, init, forward, entry points."""

    def __init__(self, cfg: ModelConfig, attn_impl: str = "blocked",
                 kv_block: int = 1024):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; "
                f"see {_UNPORTED.get(cfg.family, 'ROADMAP queue 1')}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.kv_block = kv_block

    # ------------------------------------------------------------- param specs
    def _dense_layer_specs(self) -> dict:
        cfg = self.cfg
        return {"ln1": norm_params(cfg), "attn": attn_params(cfg),
                "ln2": norm_params(cfg), "mlp": mlp_params(cfg)}

    def param_specs(self) -> dict:
        cfg = self.cfg
        return {"embed": embed_params(cfg),
                "final_norm": norm_params(cfg),
                "layers": stack_specs(self._dense_layer_specs(), cfg.n_layers)}

    def init(self, gen: torch.Generator, dtype: torch.dtype = torch.float32):
        """Parameters drawn from ``gen``, on ``gen.device``."""
        return pr.init(self.param_specs(), gen, dtype)

    # --------------------------------------------------------------- caches
    def cache_specs(self, batch: int, max_seq: int) -> dict:
        """Cache tree as P-leaves (shape + logical axes)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        kv_axes = ("layers", "batch", "kvseq", "kv_heads", "head_dim")
        return {"k": P(shape, kv_axes, "zeros"), "v": P(shape, kv_axes, "zeros")}

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device = "cuda"):
        dev = resolve(device)
        return pr.tree_map(
            lambda p: torch.zeros(p.shape, dtype=dtype, device=dev),
            self.cache_specs(batch, max_seq))

    # --------------------------------------------------------------- forward
    def _dense_stack(self, params, x, mode: str, cache, pos: Optional[int]):
        cfg = self.cfg
        B, S = x.shape[:2]
        if pos is None:
            positions = torch.arange(S, device=x.device)[None, :]
        else:
            positions = torch.full((B, 1), pos, dtype=torch.long,
                                   device=x.device)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = pr.tree_map(lambda a: a[i], params["layers"])
            lc = None if cache is None else {"k": cache["k"][i],
                                             "v": cache["v"][i]}
            a_in = apply_norm(lp["ln1"], x)
            a, kv = attention_block(
                lp["attn"], a_in, cfg, mode=mode, positions=positions,
                cache=lc, cache_pos=pos, impl=self.attn_impl,
                kv_block=self.kv_block)
            x = x + a
            f_in = apply_norm(lp["ln2"], x)
            x = x + apply_mlp(lp["mlp"], f_in, cfg.mlp_kind)
            if mode == "prefill":
                ks.append(kv["k"])
                vs.append(kv["v"])
        if mode == "prefill":
            return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
        return x, cache

    def forward(self, params, batch: dict, mode: str, cache=None,
                pos: Optional[int] = None):
        """Returns (logits, aux_loss, new_cache); aux_loss is 0 (no MoE)."""
        x = embed_tokens(params["embed"], batch["tokens"], self.cfg)
        x, caches = self._dense_stack(params, x, mode, cache, pos)
        x = apply_norm(params["final_norm"], x)
        logits = logits_from_hidden(params["embed"], x, self.cfg)
        return logits, 0.0, caches

    # ------------------------------------------------------------ entry points
    def prefill_fn(self, params, batch: dict):
        """Returns (last-position logits, cache sized to the prefix)."""
        logits, _, caches = self.forward(params, batch, "prefill")
        return logits[:, -1], caches

    def decode_fn(self, params, cache, batch: dict):
        """batch: {'tokens': (B,1), 'pos': int}.  One new token; ``cache`` is
        updated in place and returned."""
        pos = batch["pos"]
        logits, _, new_cache = self.forward(params, batch, "decode",
                                            cache=cache, pos=pos)
        return logits[:, -1], new_cache


def build_model(cfg: ModelConfig, attn_impl: str = "blocked",
                kv_block: int = 1024) -> LM:
    return LM(cfg, attn_impl=attn_impl, kv_block=kv_block)
