"""The port's CUDA kernels on the card: each against its plain version.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so on the card it runs as

    python -m pytest -q -m cuda --noconftest tests/test_torch_kernels_cuda.py

Tolerances are the reference's kernel-test ones: 2e-5 in f32 (the kernel
runs f32 in full f32, never TF32), 2e-2 in bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRID = [  # the reference's kernel-test grid, then head dims 256 and 128
    (128, 128, 4, 4, 64), (256, 256, 4, 1, 64), (128, 384, 8, 2, 32),
    (100, 200, 4, 2, 64), (300, 170, 8, 2, 256), (200, 333, 4, 2, 128)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,h,kvh,d", GRID)
def test_flash_kernel_matches_plain(cuda_device, sq, sk, h, kvh, d, causal,
                                    dtype):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda_device, dtype)
               for s in ((2, h, sq, d), (2, kvh, sk, d), (2, kvh, sk, d)))
    before = fa.flash_attention_bhsd.launches
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bhsd.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_strided_views(cuda_device, dtype):
    """(B,S,H,D) tensors transposed to (B,H,S,D) views go in without a copy
    and the output comes back laid out (B,S,H,D)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda_device, dtype)
               for s in ((2, 50, 8, 64), (2, 70, 2, 64), (2, 70, 2, 64)))
    got = fa.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True)
    assert got.transpose(1, 2).is_contiguous()
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=True)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_kernel_rejects_misaligned_bf16(cuda_device):
    x = torch.zeros((1, 2, 16, 33), dtype=torch.bfloat16, device=cuda_device)
    q = x[..., 1:]                          # 2-byte offset, odd strides
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_bhsd(q, q, q, causal=True)


def test_reduced_serve_through_kernel_matches_blocked(cuda_device):
    """Reduced chatglm3-6b in f32: greedy tokens through the kernel equal
    those through plain blocked attention, one launch per layer and prompt."""
    cfg = reduced_config(ARCHS["chatglm3-6b"])
    flash, blocked = (build_model(cfg, attn_impl=i) for i in ("flash",
                                                              "blocked"))
    params = flash.init(torch.Generator(cuda_device).manual_seed(0))
    prompts = [[3, 1, 4, 1, 5], list(range(1, 40))]
    before = fa.flash_attention_bhsd.launches
    got = ServeEngine(flash, params, max_seq=48).generate(prompts, 6)
    assert fa.flash_attention_bhsd.launches == before + cfg.n_layers * 2
    want = ServeEngine(blocked, params, max_seq=48).generate(prompts, 6)
    assert got == want
