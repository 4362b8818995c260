"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses

from .base import ModelConfig, MoEConfig, SSMConfig
from . import (
    paligemma_3b,
    zamba2_1p2b,
    nemotron_4_340b,
    qwen1p5_32b,
    qwen1p5_110b,
    chatglm3_6b,
    mamba2_1p3b,
    llama4_scout_17b_a16e,
    grok_1_314b,
    whisper_large_v3,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        paligemma_3b.CONFIG,
        zamba2_1p2b.CONFIG,
        nemotron_4_340b.CONFIG,
        qwen1p5_32b.CONFIG,
        qwen1p5_110b.CONFIG,
        chatglm3_6b.CONFIG,
        mamba2_1p3b.CONFIG,
        llama4_scout_17b_a16e.CONFIG,
        grok_1_314b.CONFIG,
        whisper_large_v3.CONFIG,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (shapes + no-NaN asserts).

    Preserves every structural feature (GQA ratio, MoE routing, SSD, hybrid
    sharing, enc-dec, stub frontends, partial rotary, biases) at toy width.
    """
    kv_ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1)) if cfg.n_heads else 1
    n_heads = 4 if cfg.n_heads else 0
    n_kv = max(1, n_heads // kv_ratio) if cfg.n_heads else 0
    updates = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family in ("ssm", "hybrid") else 2),
        d_model=128,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=32 if cfg.n_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        optimizer="adamw",
    )
    if cfg.ssm is not None:
        updates["ssm"] = SSMConfig(
            d_state=min(cfg.ssm.d_state, 16),
            d_conv=cfg.ssm.d_conv,
            expand=cfg.ssm.expand,
            head_dim=16,
            chunk=16,
            n_groups=cfg.ssm.n_groups,
        )
    if cfg.moe is not None:
        updates["moe"] = MoEConfig(
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            n_shared_experts=cfg.moe.n_shared_experts,
            capacity_factor=cfg.moe.capacity_factor,
        )
    if cfg.shared_attn_every:
        updates["shared_attn_every"] = 2
    if cfg.n_encoder_layers:
        updates["n_encoder_layers"] = 2
    if cfg.n_frames:
        updates["n_frames"] = 8
    if cfg.n_img_tokens:
        updates["n_img_tokens"] = 4
    return dataclasses.replace(cfg, **updates)
