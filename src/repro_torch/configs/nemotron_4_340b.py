"""nemotron-4-340b [dense] — GQA, squared-ReLU [arXiv:2402.16819; unverified].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
Biggest-memory cell in the sweep: defaults to adafactor + full remat so the
train_4k cell fits 16 GiB/chip HBM on the 16x16 mesh (see DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab_size=256_000,
    mlp_kind="sq_relu",
    norm_kind="layernorm",
    optimizer="adafactor",
    source="arXiv:2402.16819; unverified",
)
