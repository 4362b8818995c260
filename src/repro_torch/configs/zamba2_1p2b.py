"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention [arXiv:2411.15242; hf].

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
38 Mamba2 layers; ONE weight-shared attention+MLP block applied every 6
layers (simplified from the paper's two alternating shared blocks with
per-invocation LoRA — see DESIGN.md §8).  Runs long_500k.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    mlp_kind="gelu",
    norm_kind="rmsnorm",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    shared_attn_every=6,
    source="arXiv:2411.15242; hf",
)
