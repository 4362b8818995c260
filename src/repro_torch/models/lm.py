"""The language models: one class, six families.

Counterpart of ``repro.models.lm``.  ``LM`` builds the parameter-spec tree,
initializes it and provides the entry points:

* ``loss_fn(params, batch)``            — next-token loss (``mode="train"``)
* ``prefill_fn(params, batch)``         — last-position logits + cache
* ``decode_fn(params, cache, batch)``   — one new token against the cache

Parameters keep the reference's tree (per-layer leaves stacked on a leading
``layers`` axis) and the caches its leaves, so both packages compare leaf
for leaf:

* dense, moe, vlm: ``{"k", "v"}`` of shape (L, B, S, KVH, HD); with
  ``kv_cache_dtype="int8"`` those in int8 plus f16 ``k_scale``/``v_scale``
  (L, B, S, KVH), written by ``decode_fn`` (prefill returns k/v as computed,
  as in the reference, whose ``ServeEngine`` therefore cannot serve an int8
  cache);
* audio (whisper): ``k``/``v`` and the cross-attention cache ``xk``/``xv``
  at the encoder's ``n_frames``, which prefill builds and decode only reads;
* ssm: the Mamba2 conv windows and SSD state; hybrid (zamba2): those plus
  ``shared_k``/``shared_v``, one entry per invocation of the shared block.

The moe family's layers run ``models.moe.apply_moe`` in place of the MLP and
sum its auxiliary loss; vlm (paligemma) replaces the first ``n_img_tokens``
positions with the batch's ``img_embeds``; audio adds sinusoidal positions
and runs the encoder over the batch's ``frames`` (self-attention without a
mask, through ``attn_impl``: flash runs K3 non-causal there), whose output
every decoder layer cross-attends.  ``lax.scan`` over layers becomes
``core.aten.repeat``: a Python loop over layer views (one ``unbind`` per
stacked leaf), whose body a loop-aware capture traces once and counts its
trips; zamba2's hybrid stack stays a Python loop, as in the reference.  In
training with ``cfg.remat == "full"`` each layer runs under
``torch.utils.checkpoint.checkpoint`` (``jax.checkpoint`` in the
reference), so its activations are recomputed in the backward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, ShapeConfig
from ..core import aten
from ..device import resolve
from ..parallel.sharding import lsc, lsc_param
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
from .moe import apply_moe, moe_params
from .params import P
from .ssm import SSD_IMPLS, apply_mamba, mamba_params

PORTED_FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
KV_CACHE_DTYPES = ("bf16", "int8")


def stack_specs(tree, n: int):
    """Prepend a 'layers' axis to every leaf of a layer spec tree."""
    return pr.tree_map(
        lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale,
                    p.dtype), tree)


def constrain_params(param_tree, spec_tree):
    """Pin a per-layer parameter tree to its logical (FSDP) sharding inside
    the layer: a no-op for the forward values, and through the backward each
    layer's weight cotangent lands in the same layout."""
    return pr.tree_map(lambda a, p: lsc_param(a, *p.axes), param_tree,
                       spec_tree)


def layer_views(tree, n: int) -> list:
    """The n per-layer trees of a tree of stacked leaves, from one ``unbind``
    per leaf.  Indexing ``a[i]`` in the layer loop instead would make the
    backward of each select write a zero tensor the size of the whole leaf.
    On a mesh each layer's gradient is reduced into its slice's placements
    as the layer's backward computes it (``aten.grad_in_placements``)."""
    per_leaf = pr.tree_map(
        lambda a: [aten.grad_in_placements(t) for t in a.unbind(0)], tree)
    return [pr.tree_map(lambda t, i=i: t[i], per_leaf) for i in range(n)]


def _sinusoidal(positions: torch.Tensor, d: int,
                dtype: torch.dtype) -> torch.Tensor:
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


class LM:
    """A language model of any registry family: specs, init, forward, entry
    points.

    ``ssd_impl`` picks the Mamba2 scan of the ssm and hybrid families:
    ``"chunked"`` (plain PyTorch; the reference's ``"jnp"``) or ``"kernel"``
    (``kernels.ops.ssd_scan`` over K4; the reference's ``"pallas"``).
    ``kv_cache_dtype`` is ``"bf16"`` (the cache in the dtype ``init_cache``
    is given) or ``"int8"`` (quantized, for decode).  ``moe_dropped``, where
    set to a list, collects each MoE layer's count of assignments over
    capacity (``apply_moe``'s ``dropped``).
    """

    def __init__(self, cfg: ModelConfig, attn_impl: str = "blocked",
                 kv_block: int = 1024, ssd_impl: str = "chunked",
                 kv_cache_dtype: str = "bf16"):
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        if ssd_impl not in SSD_IMPLS:
            raise ValueError(f"unknown SSD impl {ssd_impl!r}; use one of "
                             f"{SSD_IMPLS}")
        if kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"unknown KV cache dtype {kv_cache_dtype!r}; use "
                             f"one of {KV_CACHE_DTYPES}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.kv_block = kv_block
        self.ssd_impl = ssd_impl
        self.kv_cache_dtype = kv_cache_dtype
        self.moe_dropped: Optional[list] = None

    # ------------------------------------------------------------- param specs
    def _encoder_layer_specs(self) -> dict:
        """A pre-norm attention + MLP block: whisper's encoder layer and
        zamba2's shared block."""
        cfg = self.cfg
        return {"ln1": norm_params(cfg), "attn": attn_params(cfg),
                "ln2": norm_params(cfg), "mlp": mlp_params(cfg)}

    def _dense_layer_specs(self) -> dict:
        """A decoder layer: dense, moe (the MoE FFN in place of the MLP),
        vlm, and audio (with cross-attention, ``ln_x``/``xattn``)."""
        cfg = self.cfg
        out = {"ln1": norm_params(cfg), "attn": attn_params(cfg),
               "ln2": norm_params(cfg)}
        if cfg.moe is not None:
            out["moe"] = moe_params(cfg)
        else:
            out["mlp"] = mlp_params(cfg)
        if cfg.family == "audio":
            out["ln_x"] = norm_params(cfg)
            out["xattn"] = attn_params(cfg)
        return out

    def param_specs(self) -> dict:
        cfg = self.cfg
        specs = {"embed": embed_params(cfg), "final_norm": norm_params(cfg)}
        if cfg.family in ("ssm", "hybrid"):
            layer = {"ln": norm_params(cfg), "mamba": mamba_params(cfg)}
            specs["layers"] = stack_specs(layer, cfg.n_layers)
            if cfg.family == "hybrid":
                specs["shared_attn"] = self._encoder_layer_specs()
        else:
            specs["layers"] = stack_specs(self._dense_layer_specs(),
                                          cfg.n_layers)
        if cfg.family == "audio":
            specs["encoder"] = {
                "layers": stack_specs(self._encoder_layer_specs(),
                                      cfg.n_encoder_layers),
                "final_norm": norm_params(cfg)}
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
        """Cache tree as P-leaves (shape + logical axes; int8 and f16 leaves
        name their dtype)."""
        cfg = self.cfg
        L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        kv_axes = ("layers", "batch", "kvseq", "kv_heads", "head_dim")
        if cfg.family == "ssm":
            return self._mamba_cache_specs(batch)
        if cfg.family == "hybrid":
            shape = (self.n_shared_invocations(), batch, max_seq, kv, hd)
            return {"mamba": self._mamba_cache_specs(batch),
                    "shared_k": P(shape, kv_axes, "zeros"),
                    "shared_v": P(shape, kv_axes, "zeros")}
        q8 = self.kv_cache_dtype == "int8"

        def kv_leaf(seq):
            return P((L, batch, seq, kv, hd), kv_axes, "zeros",
                     dtype="int8" if q8 else None)

        if cfg.family == "audio":   # as in the reference: no scale leaves
            cross = (L, batch, cfg.n_frames, kv, hd)
            return {"k": kv_leaf(max_seq), "v": kv_leaf(max_seq),
                    "xk": P(cross, kv_axes, "zeros"),
                    "xv": P(cross, kv_axes, "zeros")}
        out = {"k": kv_leaf(max_seq), "v": kv_leaf(max_seq)}
        if q8:
            for name in ("k_scale", "v_scale"):
                out[name] = P((L, batch, max_seq, kv), kv_axes[:-1], "zeros",
                              dtype="float16")
        return out

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device = "cuda"):
        dev = resolve(device)
        return pr.tree_map(
            lambda p: torch.zeros(p.shape, dtype=pr.leaf_dtype(p, dtype),
                                  device=dev),
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

    def _embed_inputs(self, params, batch: dict, mode: str,
                      pos: Optional[int]) -> torch.Tensor:
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, cfg)
        if cfg.family == "vlm" and mode != "decode":
            img = batch["img_embeds"].to(x.dtype)
            x = torch.cat([img, x[:, img.shape[1]:]], dim=1)
        if cfg.family == "audio":
            start = 0 if pos is None else pos
            positions = start + torch.arange(tokens.shape[1],
                                             device=x.device)
            x = x + _sinusoidal(positions, cfg.d_model, x.dtype)[None]
        return x

    def _run_encoder(self, params, frames: torch.Tensor,
                     mode: str) -> torch.Tensor:
        """Whisper's encoder over (B, n_frames, d) frame embeddings:
        sinusoidal positions, then pre-norm layers of self-attention without
        a mask (through ``attn_impl``) and the MLP."""
        cfg = self.cfg
        x = frames + _sinusoidal(torch.arange(frames.shape[1],
                                              device=frames.device),
                                 cfg.d_model, frames.dtype)[None]

        enc_specs = self._encoder_layer_specs()

        def layer(h, lp):
            lp = constrain_params(lp, enc_specs)
            a, _ = attention_block(lp["attn"], apply_norm(lp["ln1"], h), cfg,
                                   mode="train", causal=False,
                                   impl=self.attn_impl,
                                   kv_block=self.kv_block)
            h = h + a
            return h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h),
                                 cfg.mlp_kind)

        def step(x, i, lp):
            return self._run_layer(layer, mode, x, lp), None

        enc = params["encoder"]
        x, _ = aten.repeat(step, cfg.n_encoder_layers, x,
                           xs=(enc["layers"],))
        return apply_norm(enc["final_norm"], x)

    def _dense_stack(self, params, x, mode: str, cache, pos: Optional[int],
                     cross_x: Optional[torch.Tensor]):
        """The decoder layers of the dense, moe, vlm and audio families.
        Returns (x, aux, cache)."""
        cfg = self.cfg
        positions = self._positions(x, pos)
        has_xattn = cfg.family == "audio"
        self_keys = ("k", "v", "k_scale", "v_scale")
        layer_specs = self._dense_layer_specs()

        def layer(x, lp, lc, cross_x):
            lp = constrain_params(lp, layer_specs)
            sc = xc = None
            if lc is not None:
                sc = {n: lc[n] for n in self_keys if n in lc}
                if has_xattn:
                    xc = {"k": lc["xk"], "v": lc["xv"], "cross": True}
            a, kv = attention_block(
                lp["attn"], apply_norm(lp["ln1"], x), cfg, mode=mode,
                positions=positions, cache=sc, cache_pos=pos,
                impl=self.attn_impl, kv_block=self.kv_block)
            x = x + a
            xkv = None
            if has_xattn:
                xa, xkv = attention_block(
                    lp["xattn"], apply_norm(lp["ln_x"], x), cfg, mode=mode,
                    cross_x=cross_x if mode != "decode" else None, cache=xc,
                    impl=self.attn_impl, kv_block=self.kv_block)
                x = x + xa
            f_in = apply_norm(lp["ln2"], x)
            if cfg.moe is not None:
                f, aux = apply_moe(lp["moe"], f_in, cfg, mode == "train",
                                   dropped=self.moe_dropped)
            else:
                f, aux = apply_mlp(lp["mlp"], f_in, cfg.mlp_kind), 0.0
            return lsc(x + f, "batch", "rseq", "embed"), aux, kv, xkv

        def step(carry, i, lp, lc, cross_x):
            x, aux_sum = carry
            x, aux, kv, xkv = self._run_layer(layer, mode, x, lp, lc,
                                              cross_x)
            new = None
            if mode == "prefill":
                new = {"k": kv["k"], "v": kv["v"]}
                if xkv is not None:
                    new.update(xk=xkv["k"], xv=xkv["v"])
            return (x, aux_sum + aux), new

        (x, aux_sum), new = aten.repeat(
            step, cfg.n_layers, (x, 0.0), xs=(params["layers"],),
            views=(cache,), consts=(cross_x,))
        if mode == "prefill":
            return x, aux_sum, self._stack_layers(new)
        return x, aux_sum, cache

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
        return {k: aten.stack([c[k] for c in per_layer])
                for k in per_layer[0]}

    def _ssm_stack(self, params, x, mode: str, cache):
        specs = {"ln": norm_params(self.cfg), "mamba": mamba_params(self.cfg)}

        def layer(x, lp, lc):
            x, new_lc = self._mamba_layer(x, constrain_params(lp, specs),
                                          mode, lc)
            return lsc(x, "batch", "rseq", "embed"), new_lc

        def step(x, i, lp, lc):
            x, new_lc = self._run_layer(layer, mode, x, lp, lc)
            return x, new_lc if mode == "prefill" else None

        x, new = aten.repeat(step, self.cfg.n_layers, x,
                             xs=(params["layers"],), views=(cache,))
        if mode == "prefill":
            return x, self._stack_layers(new)
        return x, cache

    def _hybrid_stack(self, params, x, mode: str, cache, pos: Optional[int]):
        """zamba2: the shared attention+MLP block runs before every
        ``shared_attn_every``-th Mamba2 layer, starting at layer 0."""
        cfg = self.cfg
        sp = constrain_params(params["shared_attn"],
                              self._encoder_layer_specs())
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
        """Returns (logits, aux_loss, new_cache); aux_loss is the MoE layers'
        summed auxiliary loss, 0.0 without MoE."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch, mode, pos)
        if cfg.family == "ssm":
            x, caches = self._ssm_stack(params, x, mode, cache)
            aux = 0.0
        elif cfg.family == "hybrid":
            x, caches = self._hybrid_stack(params, x, mode, cache, pos)
            aux = 0.0
        else:
            cross_x = None
            if cfg.family == "audio" and mode != "decode":
                cross_x = self._run_encoder(params, batch["frames"], mode)
            x, aux, caches = self._dense_stack(params, x, mode, cache, pos,
                                               cross_x)
        x = apply_norm(params["final_norm"], x)
        logits = logits_from_hidden(params["embed"], x, cfg)
        return logits, aux, caches

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

    # ------------------------------------------------------------- input specs
    def input_specs(self, shape: ShapeConfig,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
        """Stand-ins (``meta`` tensors: shape and dtype, no storage) for every
        model input of ``shape``; ``pos`` of a decode step is a Python int."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def meta(shp, dt):
            return torch.empty(shp, dtype=dt, device="meta")

        if shape.kind == "decode":
            return {"tokens": meta((B, 1), torch.long), "pos": S - 1}
        batch = {"tokens": meta((B, S), torch.long)}
        if cfg.family == "vlm":
            batch["img_embeds"] = meta((B, cfg.n_img_tokens, cfg.d_model),
                                       dtype)
        if cfg.family == "audio":
            batch["frames"] = meta((B, cfg.n_frames, cfg.d_model), dtype)
        return batch


    def batch_logical_axes(self, shape: ShapeConfig) -> dict:
        """Logical axes of each model input of ``shape`` (``lsc``'s axes,
        for the batch's placements on a mesh)."""
        cfg = self.cfg
        out = {"tokens": ("batch", "seq")}
        if shape.kind == "decode":
            out = {"tokens": ("batch", "seq"), "pos": ()}
        if cfg.family == "vlm" and shape.kind != "decode":
            out["img_embeds"] = ("batch", "seq", "embed")
        if cfg.family == "audio" and shape.kind != "decode":
            out["frames"] = ("batch", "frames", "embed")
        return out


def build_model(cfg: ModelConfig, attn_impl: str = "blocked",
                kv_block: int = 1024, ssd_impl: str = "chunked",
                kv_cache_dtype: str = "bf16") -> LM:
    return LM(cfg, attn_impl=attn_impl, kv_block=kv_block, ssd_impl=ssd_impl,
              kv_cache_dtype=kv_cache_dtype)
