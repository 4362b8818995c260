"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 (per expert) vocab=131072,
MoE 8e top-2.  8 experts do not divide the 16-way model axis, so grok uses
expert-TENSOR parallelism (each expert's FFN sharded 16-way over 'model')
instead of expert parallelism — see parallel/sharding.py.
Defaults to adafactor (314B params; AdamW fp32 moments + fp32 grads would
not leave activation headroom at 16 GiB/chip).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    moe=MoEConfig(n_experts=8, top_k=2),
    optimizer="adafactor",
    source="hf:xai-org/grok-1; unverified",
)
