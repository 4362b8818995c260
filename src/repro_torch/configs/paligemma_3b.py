"""paligemma-3b [vlm] — SigLIP + gemma decoder [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1 = MQA) d_ff=16384 vocab=257216.
The SigLIP tower is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings (B, 256, d_model).  Gemma-style: GeGLU MLP,
head_dim=256, tied embeddings, RMSNorm.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab_size=257_216,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    tie_embeddings=True,
    n_img_tokens=256,
    source="arXiv:2407.07726; hf",
)
