"""Cache sizing from the spec tree declared in ``LM.cache_specs``.

The k/v of the attention families (int8 with f16 scales for an int8 cache)
and the hybrid family's shared_k/shared_v grow with the sequence; the Mamba2
conv windows and SSD state, and whisper's cross cache at ``n_frames``, do
not (an ssm model has 0 bytes per token).  Each leaf counts at its own dtype
where its spec names one, else at ``dtype``.
"""
from __future__ import annotations

import torch

from ..models import params as pr
from ..models.lm import LM


def cache_bytes(model: LM, batch: int, max_seq: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    return pr.bytes_of(model.cache_specs(batch, max_seq), dtype)


def kv_token_bytes(model: LM, dtype: torch.dtype = torch.bfloat16
                   ) -> tuple[float, float]:
    """Affine decomposition of :func:`cache_bytes` over the sequence axis:
    ``(bytes_per_token, bytes_per_request)`` such that for one request

        cache_bytes(model, 1, seq) == bytes_per_request
                                      + bytes_per_token * seq

    exactly, for every ``seq >= 1`` (every cache leaf is proportional to the
    sequence axis or independent of it, so two evaluations recover both).
    """
    span = 128
    b_lo = cache_bytes(model, 1, 1, dtype)
    b_hi = cache_bytes(model, 1, 1 + span, dtype)
    per_token = (b_hi - b_lo) / span
    return float(per_token), float(b_lo - per_token)
