"""Configuration dataclasses for models, shapes and runs.

Every assigned architecture is expressed as a ``ModelConfig``; every assigned
input shape as a ``ShapeConfig``.  Configs are plain frozen dataclasses so they
can be hashed, diffed and serialized without pulling in jax.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts routing of a ``ModelConfig``."""

    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0          # shared (always-on) experts, llama4-style
    capacity_factor: float = 1.25      # train-time per-expert capacity factor
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block of a ``ModelConfig``."""

    d_state: int = 128                 # N (SSD state size per head)
    d_conv: int = 4                    # depthwise conv kernel width
    expand: int = 2                    # d_inner = expand * d_model
    head_dim: int = 64                 # P (SSD head dim)
    chunk: int = 256                   # SSD chunk length
    n_groups: int = 1                  # B/C groups (1 = shared across heads)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Field names follow the assignment sheet."""

    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                       # query heads (0 for attn-free)
    n_kv_heads: int                    # KV heads (GQA); == n_heads for MHA
    d_ff: int                          # FFN hidden (per-expert for MoE); 0 for attn-free
    vocab_size: int
    d_head: int = 0                    # 0 -> d_model // n_heads
    mlp_kind: str = "swiglu"           # swiglu | geglu | sq_relu | gelu
    norm_kind: str = "rmsnorm"         # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_fraction: float = 1.0         # fraction of head_dim carrying rotary (chatglm: 0.5)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one weight-shared attention+MLP block applied every k layers
    shared_attn_every: int = 0
    # encoder-decoder (whisper): n_layers is the decoder depth
    n_encoder_layers: int = 0
    n_frames: int = 0                  # stub frontend: precomputed frame embeddings
    # vlm (paligemma): stub frontend: precomputed patch embeddings
    n_img_tokens: int = 0
    # training-policy knobs (per-arch defaults; overridable per run)
    optimizer: str = "adamw"           # adamw | adafactor
    remat: str = "full"                # full | none
    # provenance
    source: str = ""

    # ------------------------------------------------------------------ derived
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards on any mesh axis."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.ssm is not None

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic + O(1)-ish state: SSM and hybrid run long_500k."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_dense_layers(self) -> int:
        return self.n_layers

    # ------------------------------------------------------------- param count
    def param_count(self) -> int:
        """Exact parameter count of the model as built (padded vocab)."""
        d, V = self.d_model, self.padded_vocab
        norm_size = 2 * d if self.norm_kind == "layernorm" else d
        total = V * d                                    # embed
        if not self.tie_embeddings:
            total += V * d                               # lm head
        total += norm_size                               # final norm

        def attn_params() -> int:
            hd = self.head_dim
            p = d * self.n_heads * hd                    # q
            p += 2 * d * self.n_kv_heads * hd            # k, v
            p += self.n_heads * hd * d                   # o
            if self.qkv_bias:
                p += (self.n_heads + 2 * self.n_kv_heads) * hd
            return p

        def mlp_params(d_ff: int) -> int:
            if self.mlp_kind in ("swiglu", "geglu"):
                return 3 * d * d_ff
            return 2 * d * d_ff

        def block_norms() -> int:
            return 2 * norm_size

        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            conv_dim = di + 2 * s.n_groups * s.d_state
            per_layer = d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
            per_layer += conv_dim * s.d_conv + conv_dim                 # conv + bias
            per_layer += nh * 3                                         # dt_bias, A_log, D (per head)
            per_layer += di                                             # out gate norm
            per_layer += di * d                                         # out_proj
            per_layer += d                                              # pre-norm
            return total + self.n_layers * per_layer

        if self.family == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            conv_dim = di + 2 * s.n_groups * s.d_state
            per_layer = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            per_layer += conv_dim * s.d_conv + conv_dim
            per_layer += nh * 3 + di + di * d + d
            total += self.n_layers * per_layer
            # one shared attn+MLP block
            total += attn_params() + mlp_params(self.d_ff) + block_norms()
            return total

        per_layer = attn_params() + block_norms()
        if self.moe is not None:
            m = self.moe
            per_layer += d * m.n_experts                                  # router
            per_layer += m.n_experts * mlp_params(self.d_ff)
            per_layer += m.n_shared_experts * mlp_params(self.d_ff)
        else:
            per_layer += mlp_params(self.d_ff)

        total += self.n_layers * per_layer
        if self.n_encoder_layers:
            # encoder self-attn + mlp, and decoder cross-attn
            enc_layer = attn_params() + mlp_params(self.d_ff) + block_norms()
            total += self.n_encoder_layers * enc_layer + norm_size      # enc final norm
            total += self.n_layers * (attn_params() + norm_size)        # cross attn + its norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model

        def mlp_params(d_ff: int) -> int:
            if self.mlp_kind in ("swiglu", "geglu"):
                return 3 * d * d_ff
            return 2 * d * d_ff

        inactive_per_layer = (m.n_experts - m.top_k) * mlp_params(self.d_ff)
        return self.param_count() - self.n_layers * inactive_per_layer


@dataclass(frozen=True)
class ShapeConfig:
    """Assigned input shape. ``kind`` picks which step gets lowered."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode
    # decode: one new token against a KV cache of ``seq_len``

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


@dataclass(frozen=True)
class RunConfig:
    """Execution policy for one (arch x shape x mesh) cell."""

    model: ModelConfig
    shape: ShapeConfig
    microbatch: int = 0                # 0 -> no grad accumulation (single shot)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"
    remat: str = ""                    # '' -> model default
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_compression: str = "none"     # none | int8_ef
    seed: int = 0

    def resolved_remat(self) -> str:
        return self.remat or self.model.remat

    def microbatches(self) -> int:
        if self.microbatch <= 0:
            return 1
        assert self.shape.global_batch % self.microbatch == 0
        return self.shape.global_batch // self.microbatch
