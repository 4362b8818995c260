"""mamba2-1.3b [ssm] — SSD, attention-free [arXiv:2405.21060; unverified].

48L d_model=2048 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
d_inner = 2*d_model = 4096, head_dim=64 -> 64 SSD heads.  Runs long_500k.
Vocab padded to 50432 so it shards on a 16-way axis (DESIGN.md §8).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    norm_kind="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    source="arXiv:2405.21060; unverified",
)
