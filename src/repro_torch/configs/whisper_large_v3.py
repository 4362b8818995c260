"""whisper-large-v3 [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356].

32L (decoder; + 32 encoder layers) d_model=1280 20H (kv=20) d_ff=5120
vocab=51866.  The mel-spectrogram conv stem is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings (B, 1500, d_model).
LayerNorm (not RMS), GELU MLP, learned positions (we use rope_fraction=0 and
a learned positional table).  Vocab padded to 51968 for sharding.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    mlp_kind="gelu",
    norm_kind="layernorm",
    rope_fraction=0.0,
    n_encoder_layers=32,
    n_frames=1500,
    source="arXiv:2212.04356; unverified",
)
