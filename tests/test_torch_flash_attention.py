"""K3 flash attention: the port against the JAX package.

The port's ``flash_attention_bhsd`` on CPU tensors (its plain version) is
held against the Pallas kernel run in interpret mode, over the grid of the
reference's own kernel test, at the reference's tolerances (2e-5 in f32,
2e-2 in bf16).  The CUDA kernel's own tests are in test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

GRID = [
    (128, 128, 4, 4, 64),        # MHA, single block
    (256, 256, 4, 1, 64),        # MQA, multi-block
    (128, 384, 8, 2, 32),        # GQA, sk > sq
    (100, 200, 4, 2, 64),        # ragged
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, H, KVH, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, sq, d), dtype=np.float32),
            rng.standard_normal((B, KVH, sk, d), dtype=np.float32),
            rng.standard_normal((B, KVH, sk, d), dtype=np.float32))


def _torch(xs, dtype):
    return [torch.from_numpy(x).to(TORCH_DTYPES[dtype]) for x in xs]


def _jax(xs, dtype):
    return [jnp.asarray(x).astype(JAX_DTYPES[dtype]) for x in xs]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,h,kvh,d", GRID)
def test_plain_matches_pallas_interpret(sq, sk, h, kvh, d, causal, dtype):
    xs = _inputs(0, 2, h, kvh, sq, sk, d)
    want = jax_flash(*_jax(xs, dtype), causal=causal, block_q=128,
                     block_k=128, interpret=True)
    got = fa.flash_attention_bhsd(*_torch(xs, dtype), causal=causal)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (2, h, sq, d)
    _close(got.float(), want.astype(jnp.float32), TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k", [(32, 64), (64, 32), (100, 200)])
def test_plain_block_size_invariant(block_q, block_k, causal):
    q, k, v = _torch(_inputs(1, 2, 8, 2, 100, 200, 32), "float32")
    base = fa.flash_attention_bhsd(q, k, v, causal=causal)
    got = fa.flash_attention_bhsd(q, k, v, causal=causal, block_q=block_q,
                                  block_k=block_k)
    _close(got, base, 1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_ops_bshd_layout_matches_oracle(causal):
    xs = _inputs(2, 2, 8, 2, 100, 200, 32)
    want = jref.flash_attention_ref(*_jax(xs, "float32"), causal=causal)
    q, k, v = (t.transpose(1, 2).contiguous() for t in _torch(xs, "float32"))
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.shape == (2, 100, 8, 32)
    _close(got.transpose(1, 2), want, TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_port_oracle_matches_reference_oracle(causal):
    xs = _inputs(5, 2, 8, 2, 100, 200, 32)
    want = jref.flash_attention_ref(*_jax(xs, "float32"), causal=causal)
    _close(tref.flash_attention_ref(*_torch(xs, "float32"), causal=causal),
           want, TOL["float32"])


def test_rejects_bad_inputs():
    q, k, v = _torch(_inputs(3, 1, 4, 2, 8, 8, 32), "float32")
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, k[:, :, :4], v, causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q[:, :3], k, v, causal=True)
    with pytest.raises(TypeError):
        fa.flash_attention_bhsd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):      # neither cpu nor cuda: no silent path
        fa.flash_attention_bhsd(q.to("meta"), k.to("meta"), v.to("meta"))
