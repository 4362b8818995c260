"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA [arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
GLM applies rotary to half the head dim (rope_fraction=0.5) and uses QKV bias.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    vocab_size=65_024,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    qkv_bias=True,
    rope_fraction=0.5,
    source="arXiv:2406.12793; hf",
)
