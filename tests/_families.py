"""Shared inputs of the moe, vlm and audio parity tests: the reference's
init plus seeded numpy noise, and tokens with the family's extra inputs
(image embeddings, frames) from one numpy generator."""
import jax
import numpy as np
import torch

from repro.models.lm import build_model as j_build

FAMILY_ARCHS = ["grok-1-314b", "llama4-scout-17b-a16e", "paligemma-3b",
                "whisper-large-v3"]


def perturbed_params(cfg, seed=0):
    """Reference init + seeded noise on every leaf, as a numpy tree."""
    params = j_build(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def model_inputs(cfg, batch, seq, seed=1):
    """Tokens and the family's extra inputs, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(batch, seq))}
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
