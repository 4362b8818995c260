"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048,
16 experts top-1 + 1 shared expert (llama4-style).  EP over the model axis
(16 experts / 16-way axis = 1 expert per shard).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    moe=MoEConfig(n_experts=16, top_k=1, n_shared_experts=1),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
