"""The language model: dense, ssm and hybrid families.

Counterpart of ``repro.models.lm``.  ``LM`` builds the parameter-spec tree,
initializes it and provides the entry points:

* ``loss_fn(params, batch)``            — next-token loss (``mode="train"``)
* ``prefill_fn(params, batch)``         — last-position logits + cache
* ``decode_fn(params, cache, batch)``   — one new token against the cache

Parameters keep the reference's tree (per-layer leaves stacked on a leading
``layers`` axis) and the caches its leaves: ``{"k", "v"}`` of shape
(L, B, S, KVH, HD) for the dense family, the Mamba2 conv windows and SSD
state for ``ssm``, and those plus ``shared_k``/``shared_v`` (one entry per
invocation of the shared block) for ``hybrid`` (zamba2).  So both packages
compare leaf for leaf.  ``lax.scan`` over layers becomes a Python loop over
layer views (one ``unbind`` per stacked leaf).  In training with
``cfg.remat == "full"`` each layer runs under
``torch.utils.checkpoint.checkpoint`` (``jax.checkpoint`` in the
reference), so its activations are recomputed in the backward.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

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
    next_token_loss,
    norm_params,
)
from .params import P
from .ssm import SSD_IMPLS, apply_mamba, mamba_params

PORTED_FAMILIES = ("dense", "ssm", "hybrid")
# Families not ported yet, with the ROADMAP item that ports each.
_UNPORTED = {
    "moe": "ROADMAP queue 1, the MoE slice (grok-1, llama4-scout)",
    "vlm": "ROADMAP queue 1, the VLM and audio slice (paligemma)",
    "audio": "ROADMAP queue 1, the VLM and audio slice (whisper)",
}


def stack_specs(tree, n: int):
    """Prepend a 'layers' axis to every leaf of a layer spec tree."""
    return pr.tree_map(
        lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale), tree)


def layer_views(tree, n: int) -> list:
    """The n per-layer trees of a tree of stacked leaves, from one ``unbind``
    per leaf.  Indexing ``a[i]`` in the layer loop instead would make the
    backward of each select write a zero tensor the size of the whole leaf."""
    per_leaf = pr.tree_map(lambda a: a.unbind(0), tree)
    return [pr.tree_map(lambda t, i=i: t[i], per_leaf) for i in range(n)]


class LM:
    """A language model of a ported family: specs, init, forward, entry points.

    ``ssd_impl`` picks the Mamba2 scan of the ssm and hybrid families:
    ``"chunked"`` (plain PyTorch; the reference's ``"jnp"``) or ``"kernel"``
    (``kernels.ops.ssd_scan`` over K4; the reference's ``"pallas"``).
    """

    def __init__(self, cfg: ModelConfig, attn_impl: str = "blocked",
                 kv_block: int = 1024, ssd_impl: str = "chunked"):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; "
                f"see {_UNPORTED.get(cfg.family, 'ROADMAP queue 1')}")
        if ssd_impl not in SSD_IMPLS:
            raise ValueError(f"unknown SSD impl {ssd_impl!r}; use one of "
                             f"{SSD_IMPLS}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.kv_block = kv_block
        self.ssd_impl = ssd_impl

    # ------------------------------------------------------------- param specs
    def _dense_layer_specs(self) -> dict:
        cfg = self.cfg
        return {"ln1": norm_params(cfg), "attn": attn_params(cfg),
                "ln2": norm_params(cfg), "mlp": mlp_params(cfg)}

    def param_specs(self) -> dict:
        cfg = self.cfg
        specs = {"embed": embed_params(cfg), "final_norm": norm_params(cfg)}
        if cfg.family in ("ssm", "hybrid"):
            layer = {"ln": norm_params(cfg), "mamba": mamba_params(cfg)}
            specs["layers"] = stack_specs(layer, cfg.n_layers)
            if cfg.family == "hybrid":
                specs["shared_attn"] = self._dense_layer_specs()
        else:
            specs["layers"] = stack_specs(self._dense_layer_specs(),
                                          cfg.n_layers)
        return specs

    def init(self, gen: torch.Generator, dtype: torch.dtype = torch.float32):
        """Parameters drawn from ``gen``, on ``gen.device``."""
        return pr.init(self.param_specs(), gen, dtype)

    # --------------------------------------------------------------- caches
    def n_shared_invocations(self) -> int:
        cfg = self.cfg
        if cfg.family != "hybrid":
            return 0
        return len(range(0, cfg.n_layers, cfg.shared_attn_every))

    def _mamba_cache_specs(self, batch: int) -> dict:
        cfg = self.cfg
        s = cfg.ssm
        L = cfg.n_layers
        di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
        gn = s.n_groups * s.d_state
        return {
            "conv_x": P((L, batch, s.d_conv - 1, di),
                        ("layers", "batch", "kwidth", "inner"), "zeros"),
            "conv_B": P((L, batch, s.d_conv - 1, gn),
                        ("layers", "batch", "kwidth", "state"), "zeros"),
            "conv_C": P((L, batch, s.d_conv - 1, gn),
                        ("layers", "batch", "kwidth", "state"), "zeros"),
            "state": P((L, batch, nh, s.head_dim, s.d_state),
                       ("layers", "batch", "ssm_heads", "head_dim", "state"),
                       "zeros"),
        }

    def cache_specs(self, batch: int, max_seq: int) -> dict:
        """Cache tree as P-leaves (shape + logical axes)."""
        cfg = self.cfg
        kv_axes = ("layers", "batch", "kvseq", "kv_heads", "head_dim")
        if cfg.family == "ssm":
            return self._mamba_cache_specs(batch)
        if cfg.family == "hybrid":
            shape = (self.n_shared_invocations(), batch, max_seq,
                     cfg.n_kv_heads, cfg.head_dim)
            return {"mamba": self._mamba_cache_specs(batch),
                    "shared_k": P(shape, kv_axes, "zeros"),
                    "shared_v": P(shape, kv_axes, "zeros")}
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": P(shape, kv_axes, "zeros"), "v": P(shape, kv_axes, "zeros")}

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device = "cuda"):
        dev = resolve(device)
        return pr.tree_map(
            lambda p: torch.zeros(p.shape, dtype=dtype, device=dev),
            self.cache_specs(batch, max_seq))

    # --------------------------------------------------------------- forward
    @staticmethod
    def _positions(x: torch.Tensor, pos: Optional[int]) -> torch.Tensor:
        B, S = x.shape[:2]
        if pos is None:
            return torch.arange(S, device=x.device)[None, :]
        return torch.full((B, 1), pos, dtype=torch.long, device=x.device)

    def _run_layer(self, fn, mode: str, *args):
        """``fn(*args)``, under activation checkpointing in training with
        ``remat == "full"``."""
        if mode == "train" and self.cfg.remat == "full":
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _dense_stack(self, params, x, mode: str, cache, pos: Optional[int]):
        cfg = self.cfg
        positions = self._positions(x, pos)

        def layer(x, lp, lc):
            a, kv = attention_block(
                lp["attn"], apply_norm(lp["ln1"], x), cfg, mode=mode,
                positions=positions, cache=lc, cache_pos=pos,
                impl=self.attn_impl, kv_block=self.kv_block)
            x = x + a
            x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x),
                              cfg.mlp_kind)
            return x, kv

        ks, vs = [], []
        for i, lp in enumerate(layer_views(params["layers"], cfg.n_layers)):
            lc = None if cache is None else {"k": cache["k"][i],
                                             "v": cache["v"][i]}
            x, kv = self._run_layer(layer, mode, x, lp, lc)
            if mode == "prefill":
                ks.append(kv["k"])
                vs.append(kv["v"])
        if mode == "prefill":
            return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
        return x, cache

    def _mamba_layer(self, x, lp, mode: str, lc):
        """Pre-norm Mamba2 residual layer with the layer's cache ``lc``.
        Returns (x, the layer's new cache); decode updates ``lc`` in place."""
        m, new_lc = apply_mamba(lp["mamba"], apply_norm(lp["ln"], x),
                                self.cfg, mode=mode, cache=lc,
                                impl=self.ssd_impl)
        return x + m, new_lc

    @staticmethod
    def _layer_cache(cache, i: int):
        return None if cache is None else pr.tree_map(lambda a: a[i], cache)

    @staticmethod
    def _stack_layers(per_layer: list) -> dict:
        return {k: torch.stack([c[k] for c in per_layer])
                for k in per_layer[0]}

    def _ssm_stack(self, params, x, mode: str, cache):
        new = []
        for i, lp in enumerate(layer_views(params["layers"],
                                           self.cfg.n_layers)):
            x, new_lc = self._run_layer(self._mamba_layer, mode, x, lp, mode,
                                        self._layer_cache(cache, i))
            new.append(new_lc)
        if mode == "prefill":
            return x, self._stack_layers(new)
        return x, cache

    def _hybrid_stack(self, params, x, mode: str, cache, pos: Optional[int]):
        """zamba2: the shared attention+MLP block runs before every
        ``shared_attn_every``-th Mamba2 layer, starting at layer 0."""
        cfg = self.cfg
        sp = params["shared_attn"]
        positions = self._positions(x, pos)
        mamba_cache = None if cache is None else cache["mamba"]

        def layer(x, lp, lc, ic, use_attn: bool):
            kv = None
            if use_attn:
                a, kv = attention_block(
                    sp["attn"], apply_norm(sp["ln1"], x), cfg, mode=mode,
                    positions=positions, cache=ic, cache_pos=pos,
                    impl=self.attn_impl, kv_block=self.kv_block)
                x = x + a
                x = x + apply_mlp(sp["mlp"], apply_norm(sp["ln2"], x),
                                  cfg.mlp_kind)
            x, new_lc = self._mamba_layer(x, lp, mode, lc)
            return x, new_lc, kv

        new, ks, vs = [], [], []
        for i, lp in enumerate(layer_views(params["layers"], cfg.n_layers)):
            use_attn = i % cfg.shared_attn_every == 0
            ic = None
            if use_attn and cache is not None:
                inv = i // cfg.shared_attn_every
                ic = {"k": cache["shared_k"][inv], "v": cache["shared_v"][inv]}
            x, new_lc, kv = self._run_layer(
                layer, mode, x, lp, self._layer_cache(mamba_cache, i), ic,
                use_attn)
            if use_attn and mode == "prefill":
                ks.append(kv["k"])
                vs.append(kv["v"])
            new.append(new_lc)
        if mode == "prefill":
            return x, {"mamba": self._stack_layers(new),
                       "shared_k": torch.stack(ks),
                       "shared_v": torch.stack(vs)}
        return x, cache

    def forward(self, params, batch: dict, mode: str, cache=None,
                pos: Optional[int] = None):
        """Returns (logits, aux_loss, new_cache); aux_loss is 0 (no MoE)."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], batch["tokens"], cfg)
        if cfg.family == "ssm":
            x, caches = self._ssm_stack(params, x, mode, cache)
        elif cfg.family == "hybrid":
            x, caches = self._hybrid_stack(params, x, mode, cache, pos)
        else:
            x, caches = self._dense_stack(params, x, mode, cache, pos)
        x = apply_norm(params["final_norm"], x)
        logits = logits_from_hidden(params["embed"], x, cfg)
        return logits, 0.0, caches

    # ------------------------------------------------------------ entry points
    def loss_fn(self, params, batch: dict):
        """Mean next-token loss over ``batch["tokens"]`` (B, S), through the
        training forward.  Returns (loss + aux, {"ce", "aux"})."""
        logits, aux, _ = self.forward(params, batch, "train")
        loss = next_token_loss(logits, batch["tokens"], self.cfg.vocab_size)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        return loss + aux, {"ce": loss, "aux": aux}

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
                kv_block: int = 1024, ssd_impl: str = "chunked") -> LM:
    return LM(cfg, attn_impl=attn_impl, kv_block=kv_block, ssd_impl=ssd_impl)
