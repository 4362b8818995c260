"""The port's CUDA kernels on the card: each against its plain version.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so on the card it runs as

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernels_cuda.py

Flash attention (K3) is held at the reference's kernel-test tolerances: 2e-5
in f32 (the kernel runs f32 in full f32, never TF32), 2e-2 in bf16, the
bf16 kernel also at its tile edges (127-129 and 2047 rows and keys), for
every head dim, on (B, S, H, D) views, and at the moe, vlm and audio
families' attention shapes; the reduced families serve through it as
through blocked attention, and a llama4-shaped MoE layer gives on the card
what it gives on the CPU.  The SSD
chunk kernel (K4) is held to its plain version at 1e-3 on its f32 outputs
(the kernel's cumsum is a warp scan and its products run on bf16 tensor
cores with the f32 operands split into hi and lo halves; at Q = 256 ``cs``
reaches ~-230 over a chunk, where one f32 step is 1.5e-5, so y of magnitude
~10 differs by ~1e-3) and at 2e-2 on y_diag in bf16 (stored in bf16);
states and gamma are f32 in both dtypes.  K4 is also held at the models'
chunk shapes, where cs rises on some rows (outside its factorization's
precondition, which it checks per head), and to the same bits on two
runs; where A > 0 makes cs rise over a whole chunk, its y from f32 inputs
is shown to miss 1e-3 of the exact value, the documented limit of its
split products, and to stay within twice it.  The SSD backward kernel (K5) and its plain version are held to
the same math in f64 as ``chip_smoke.py`` holds them: each
within 2e-2 + 2e-2|f64| on dx in bf16 and, on the f32 outputs, within
1e-3 + 1e-3|f64| plus 1e-4 of the largest |f64| in the output's (batch,
chunk, head) cell (for da, in its head over batch and chunks), and the two
within twice that of each other: ddt, da and dB come out of sums whose
terms cancel, so the f32 rounding of the terms lands at the scale of the
cell's largest value.
Gradients of ``ops.ssd_scan`` through K4 + K5 are held against autograd
through ``ssd_ref`` at 2e-3, the reference's tolerance for the scan.
The Table-1 kernel K1 is held to its plain version at the reference's 1e-12
relative and absolute for all 28 expressions, and bit for bit on its vector
path (aligned) and its scalar path (one element off 16-byte alignment) at
lengths with and without a ragged tail; poly16 at 1e-12 in f64 and 1e-5 in
f32 (one FMA a Horner step against a product and a sum); STREAM
Triad K2 at rtol 1e-5, atol 1e-6 in f32 and bit for bit in f64, at every
CTA cap, on both of its paths.  K5 gives the same bits on two runs.
K3, K4 and K5 are also called as the custom ops that a captured graph
holds (``torch.ops.repro_torch.*``), at the tolerances above, through
``torch.library.opcheck``, and a reduced kernel-path step captured on the
card (``core.aten``) launches nothing and holds one custom call per launch.
The scheduler's scan (``kernels.sched_scan``) equals its plain version and
the NumPy pass bit for bit (it only adds and takes maxima of float64): at
1, 4 and 48 streams, with the cross-CMG ring addend, windows up to 1024,
1 to 1000 batch elements and ops with more inputs than it stages at once;
so do ``backend="torch"``'s fixpoints on the card against ``"numpy"``,
the sampled sweep's (``core.sample``) and a model-zoo cell's O3 grid.
"""
import numpy as np
import pytest
import torch
from _ssd_split import fwd_exact, fwd_share, rising_inputs

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import stream
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRID = [  # the reference's kernel-test grid, then head dims 256 and 128
    (128, 128, 4, 4, 64), (256, 256, 4, 1, 64), (128, 384, 8, 2, 32),
    (100, 200, 4, 2, 64), (300, 170, 8, 2, 256), (200, 333, 4, 2, 128)]
# the bf16 kernel's tile edges (128 query rows a CTA, 64 a consumer
# warpgroup; 128 keys a block, 64 at D = 256): Sq != Sk, causal aligned
# top-left; G = 16 and G = 1; every head dim
GRID += [(sq, sk, h, kvh, d) for d in (32, 64, 128, 256)
         for sq, sk, h, kvh in ((127, 127, 16, 1), (128, 129, 4, 4),
                                (129, 128, 16, 1), (2047, 2047, 2, 2),
                                (127, 2047, 16, 1), (2047, 129, 16, 16))]


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
@pytest.mark.parametrize("d", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("sq,sk,h,kvh", [(50, 70, 8, 2), (129, 300, 16, 1),
                                         (300, 129, 4, 4)])
def test_flash_kernel_takes_strided_views(cuda_device, sq, sk, h, kvh, d,
                                          dtype):
    """(B,S,H,D) tensors transposed to (B,H,S,D) views go in without a copy
    (the bf16 kernel's tensor maps read them through their strides) and the
    output comes back laid out (B,S,H,D)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda_device, dtype)
               for s in ((2, sq, h, d), (2, sk, kvh, d), (2, sk, kvh, d)))
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


# the moe, vlm and audio families' attention shapes, scaled down in heads
# and length: whisper-large-v3's encoder (no mask over 1500 keys, 11 full
# key blocks and a ragged 92, D 64), paligemma-3b's (D 256, one KV head)
# and llama4-scout's (5 query heads a KV head at D 128): (label, Sq, Sk, H,
# KVH, D, causal)
FAMILY_SHAPES = [("whisper encoder", 1500, 1500, 4, 4, 64, False),
                 ("whisper decoder", 448, 448, 4, 4, 64, True),
                 ("paligemma", 320, 320, 8, 1, 256, True),
                 ("llama4-scout", 384, 384, 10, 2, 128, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,sq,sk,h,kvh,d,causal", FAMILY_SHAPES)
def test_flash_kernel_at_the_families_shapes(cuda_device, label, sq, sk, h,
                                             kvh, d, causal, dtype):
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda_device, dtype).transpose(1, 2)
               for s in ((1, sq, h, d), (1, sk, kvh, d), (1, sk, kvh, d)))
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("arch", ["whisper-large-v3", "paligemma-3b",
                                  "llama4-scout-17b-a16e"])
def test_reduced_families_serve_through_kernel_like_blocked(cuda_device,
                                                            arch):
    """Reduced models in f32 with their extra inputs: greedy tokens through
    K3 equal those through blocked attention; K3 launches once per layer
    that runs it (whisper: encoder and decoder self-attention) and prompt."""
    cfg = reduced_config(ARCHS[arch])
    flash, blocked = (build_model(cfg, attn_impl=i) for i in ("flash",
                                                              "blocked"))
    gen = torch.Generator(cuda_device).manual_seed(0)
    params = flash.init(gen)
    extra = {}
    if cfg.family == "vlm":
        extra["img_embeds"] = torch.randn(
            (1, cfg.n_img_tokens, cfg.d_model), generator=gen,
            device=cuda_device)
    if cfg.family == "audio":
        extra["frames"] = torch.randn((1, cfg.n_frames, cfg.d_model),
                                      generator=gen, device=cuda_device)
    prompts = [[3, 1, 4, 1, 5], list(range(1, 40))]
    before = fa.flash_attention_bhsd.launches
    got = ServeEngine(flash, params, max_seq=48).generate(
        prompts, 6, extra_inputs=extra)
    assert fa.flash_attention_bhsd.launches == before + 2 * (
        cfg.n_layers + cfg.n_encoder_layers)
    want = ServeEngine(blocked, params, max_seq=48).generate(
        prompts, 6, extra_inputs=extra)
    assert got == want


@pytest.mark.parametrize("shape", [(2, 64), (1, 200), (6, 1)])
def test_moe_on_the_card_matches_its_cpu_run(cuda_device, shape):
    """A llama4-shaped MoE layer (4 experts, top-1, a shared expert) in f32:
    the card's routing, dispatch, experts and index_add_ combine against the
    same call on the CPU: the same drops, outputs within 1e-5 (f32 matmuls
    in another order; TF32 off), the aux loss within 1e-6 relative; at
    (6, 1) decode's one global group."""
    from repro_torch.models.moe import apply_moe
    cfg = reduced_config(ARCHS["llama4-scout-17b-a16e"])
    p = build_model(cfg).init(torch.Generator().manual_seed(0))
    lp = {k: v[0] for k, v in p["layers"]["moe"].items()}
    x = torch.randn((*shape, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    drops_cpu, drops_card = [], []
    want, want_aux = apply_moe(lp, x, cfg, False, dropped=drops_cpu)
    got, got_aux = apply_moe({k: v.to(cuda_device) for k, v in lp.items()},
                             x.to(cuda_device), cfg, False,
                             dropped=drops_card)
    assert int(drops_card[0]) == int(drops_cpu[0])
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    np.testing.assert_allclose(got_aux.item(), want_aux.item(), rtol=1e-6)


# ------------------------------------------------------------------ K4
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
SSD_GRID = [  # (L, H, P, N, chunk): the reference's grid, Q < chunk, ragged
    (64, 2, 16, 16, 16), (128, 4, 32, 32, 32), (96, 2, 16, 8, 32),
    (100, 3, 64, 128, 256), (300, 2, 64, 64, 256), (200, 2, 128, 256, 128)]
# the models' chunk shapes at a small batch: Q 256, P 64, N 128 (mamba2-1.3b)
# and 64 (zamba2-1.2b), H 4, one chunk and two; K4 also at H 12 (a head
# block of 8 and one of 4)
MODEL_CHUNKS = [(L, 4, 64, N, 256) for N in (128, 64) for L in (256, 512)]


def _ssd_inputs(device, L, H, P, N, seed, broadcast=False,
                dtype=torch.float32):
    """The reference test's distributions: x ~ N(0,1), dt = softplus(N(0,1)),
    A = -exp(0.5 N(0,1)) in f32, B, C ~ 0.5 N(0,1); broadcast = B/C shared by
    the heads as a stride-0 expand."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(device)

    x = t((2, L, H, P)).to(dtype)
    dt = torch.nn.functional.softplus(t((2, L, H))).to(dtype)
    A = -torch.exp(t(H) * 0.5)
    heads = 1 if broadcast else H
    Bm, Cm = ((0.5 * t((2, L, heads, N))).to(dtype).expand(2, L, H, N)
              for _ in range(2))
    return x, dt, A, Bm, Cm


def _chunks(t, Q):
    B, L = t.shape[:2]
    return t[:, :L - L % Q].reshape(B, (L - L % Q) // Q, Q, *t.shape[2:])


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H,P,N,chunk", SSD_GRID + MODEL_CHUNKS
                         + [(512, 12, 64, 128, 256)])
def test_ssd_chunk_kernel_matches_plain(cuda_device, L, H, P, N, chunk,
                                        dtype, broadcast):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, L, H, P, N, 6, broadcast,
                                   dtype)
    Q = min(chunk, L)
    args = [_chunks(t, Q) for t in (x, dt)] + [A] \
        + [_chunks(t, Q) for t in (Bm, Cm)]
    assert (args[3].stride(3) == 0) == broadcast
    before = ssd.ssd_chunk.launches
    got = ssd.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ssd.ssd_chunk.launches == before + 1
    want = ssd.ssd_chunk_plain(*args)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype \
        == torch.float32
    f32_tol = SSD_TOL[torch.float32]
    for g, w, tol in zip(got, want, (SSD_TOL[dtype], f32_tol, f32_tol)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_gives_the_same_bits_twice(cuda_device, dtype,
                                                    broadcast):
    """No float atomics: each output is summed by one CTA in a fixed order,
    so two runs on the same inputs give identical bits (mamba2-1.3b's chunk
    shape, two chunks)."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, 512, 4, 64, 128, 17,
                                   broadcast, dtype)
    args = [_chunks(t, 256) for t in (x, dt)] + [A] \
        + [_chunks(t, 256) for t in (Bm, Cm)]
    first = ssd.ssd_chunk(*args)
    second = ssd.ssd_chunk(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_where_cs_rises(cuda_device, dtype):
    """Outside the precondition of K4's factorization exp(cs_i - cs_j) =
    a_i b_j (cs falls: dt * A <= 0): heads 1, 2 and 3 have dt < 0 on a
    stretch of rows, so cs rises there.  The kernel checks each head and
    computes such a head entry by entry, so it still holds its plain
    version at the same tolerance (mamba2-1.3b's chunk shape; the stretches
    raise cs by under 2, so y and the states keep the size the absolute
    part of the tolerance is meant for)."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, 512, 4, 64, 128, 18, True,
                                   dtype)
    dt = dt.clone()
    for h, (lo, hi) in ((1, (100, 140)), (2, (0, 30)), (3, (300, 400))):
        dt[:, lo:hi, h] *= -0.05
    args = [_chunks(t, 256) for t in (x, dt)] + [A] \
        + [_chunks(t, 256) for t in (Bm, Cm)]
    assert (args[1].float() * A > 0).any()
    got = ssd.ssd_chunk(*args)
    torch.cuda.synchronize()
    want = ssd.ssd_chunk_plain(*args)
    f32_tol = SSD_TOL[torch.float32]
    for g, w, tol in zip(got, want, (SSD_TOL[dtype], f32_tol, f32_tol)):
        assert torch.isfinite(w).all()
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_where_cs_rises_over_the_chunk(cuda_device, dtype):
    """A > 0 on heads 1 and 3 (the CPU precision test's inputs,
    ``_ssd_split.rising_inputs``: B 2, nc 2, mamba2-1.3b's chunk shape, B/C
    shared by the heads), so cs rises over the whole chunk and the kernel
    computes those heads entry by entry.  Against the same math in f64:
    every output is finite, the states and gamma hold 1e-3 and y in bf16
    2e-2.  y from f32 inputs shows the scheme's documented limit: it misses
    1e-3 (the emulation of the scheme reaches 1.25 times it at these inputs)
    but stays within twice it, where the plain f32 version holds it."""
    args = rising_inputs(dtype)
    exact = fwd_exact(*args)

    def on_card(t):   # the head broadcast of B and C kept as a stride-0 view
        if t.dim() == 5 and t.stride(3) == 0:
            return t[:, :, :, :1].to(cuda_device).expand(t.shape)
        return t.to(cuda_device)

    card = [on_card(t) for t in args]
    assert card[3].stride(3) == 0
    got = [g.cpu() for g in ssd.ssd_chunk(*card)]
    assert all(torch.isfinite(g).all() for g in got)
    assert fwd_share((exact[0].to(dtype), got[1], got[2]), exact, dtype) <= 1
    y_share = fwd_share((got[0], exact[1], exact[2]), exact, dtype)
    if dtype == torch.bfloat16:
        assert y_share <= 1
    else:
        assert 1 < y_share <= 2
        assert fwd_share(ssd.ssd_chunk_plain(*args), exact, dtype) <= 1


@pytest.mark.parametrize("L,H,P,N,chunk", SSD_GRID[:3])
def test_ssd_scan_kernel_matches_sequential_ref(cuda_device, L, H, P, N,
                                                chunk):
    """The reference's own test on the card: ops.ssd_scan through K4 against
    the token-by-token recurrence at 2e-3."""
    from repro_torch.kernels import ref
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, L, H, P, N, 7)
    y, state = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y_ref, state_ref = ref.ssd_ref(x, dt, A, Bm, Cm)
    for g, w in ((y, y_ref), (state, state_ref)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_ssd_scan_kernel_initial_state_split(cuda_device):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, 64, 2, 16, 16, 8, True)
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    y1, s1 = ops.ssd_scan(x[:, :40], dt[:, :40], A, Bm[:, :40], Cm[:, :40],
                          chunk=16)
    y2, s2 = ops.ssd_scan(x[:, 40:], dt[:, 40:], A, Bm[:, 40:], Cm[:, 40:],
                          chunk=16, initial_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).cpu().numpy(),
                               y.cpu().numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(s2.cpu().numpy(), s.cpu().numpy(), rtol=2e-3,
                               atol=2e-3)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda_device):
    x, dt, A, Bm, Cm = (_chunks(t, 16) if t.dim() > 1 else t
                        for t in _ssd_inputs(cuda_device, 32, 2, 16, 16, 9))
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_chunk(x, dt, A, Bm[..., ::2], Cm[..., ::2])
    with pytest.raises(TypeError):
        ssd.ssd_chunk(x.bfloat16(), dt, A, Bm, Cm)
    big = torch.zeros((1, 1, 300, 2, 16), device=cuda_device)
    with pytest.raises(ValueError, match="Q <="):
        ssd.ssd_chunk(big, big[..., 0], A, big, big)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_reduced_serve_through_ssd_kernel_matches_chunked(cuda_device, arch):
    """Reduced mamba2/zamba2 in f32: greedy tokens through K4 equal those
    through the plain chunked scan, one launch per layer and prompt."""
    cfg = reduced_config(ARCHS[arch])
    kernel, chunked = (build_model(cfg, attn_impl="flash", ssd_impl=i)
                       for i in ("kernel", "chunked"))
    params = kernel.init(torch.Generator(cuda_device).manual_seed(0))
    prompts = [[3, 1, 4, 1, 5], list(range(1, 40))]
    before = ssd.ssd_chunk.launches
    got = ServeEngine(kernel, params, max_seq=48).generate(prompts, 6)
    assert ssd.ssd_chunk.launches == before + cfg.n_layers * 2
    want = ServeEngine(chunked, params, max_seq=48).generate(prompts, 6)
    assert got == want


# ------------------------------------------------------------------ K5
# then P 128, N 256 (both column parts of dB), and the models' chunk shapes
# at a small batch: Q 256, P 64, N 128 (mamba2-1.3b) and 64 (zamba2-1.2b),
# H 4, one chunk and two
BWD_GRID = SSD_GRID + [(48, 3, 8, 16, 48)] + MODEL_CHUNKS


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H,P,N,chunk", BWD_GRID)
def test_ssd_bwd_kernel_matches_plain(cuda_device, L, H, P, N, chunk, dtype,
                                      broadcast):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, L, H, P, N, 10, broadcast,
                                   dtype)
    Q = min(chunk, L)
    args = [_chunks(t, Q) for t in (x, dt)] + [A] \
        + [_chunks(t, Q) for t in (Bm, Cm)]
    B, nc = args[0].shape[:2]
    rng = np.random.default_rng(11)
    dy = torch.from_numpy(rng.standard_normal(
        (B, nc, Q, H, P), dtype=np.float32)).to(cuda_device, dtype)
    dstates = torch.from_numpy(rng.standard_normal(
        (B, nc, H, N, P), dtype=np.float32)).to(cuda_device)
    dgamma = torch.from_numpy(rng.standard_normal(
        (B, nc, H), dtype=np.float32)).to(cuda_device)
    before = ssd.ssd_chunk_bwd.launches
    got = ssd.ssd_chunk_bwd(*args, dy, dstates, dgamma)
    torch.cuda.synchronize()
    assert ssd.ssd_chunk_bwd.launches == before + 1
    want = ssd.ssd_chunk_bwd_plain(*args, dy, dstates, dgamma)
    exact = ssd.ssd_chunk_bwd_plain(*(t.double() for t in (
        *args, dy, dstates, dgamma)))
    assert got[0].dtype == dtype

    def allowed(i, ref):
        if i == 0 and dtype == torch.bfloat16:
            return 2e-2 * (1 + np.abs(ref))
        group = {4: (0, 1), 1: (2,)}.get(i, (2, 4))   # head or cell
        return (1e-3 * (1 + np.abs(ref))
                + 1e-4 * np.abs(ref).max(group, keepdims=True))

    for i, (g, w, e) in enumerate(zip(got, want, exact)):
        assert g.shape == w.shape and g.dtype == w.dtype
        g, w, e = (t.double().cpu().numpy() for t in (g, w, e))
        assert (np.abs(g - e) <= allowed(i, e)).all(), i
        assert (np.abs(w - e) <= allowed(i, e)).all(), i
        assert (np.abs(g - w) <= 2 * allowed(i, w)).all(), i


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_gives_the_same_bits_twice(cuda_device, dtype,
                                                  broadcast):
    """No float atomics: the sums run in a fixed order, so two runs on the
    same inputs give identical bits (mamba2-1.3b's chunk shape, two
    chunks)."""
    L, H, P, N, Q = 512, 4, 64, 128, 256
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, L, H, P, N, 15, broadcast,
                                   dtype)
    args = [_chunks(t, Q) for t in (x, dt)] + [A] \
        + [_chunks(t, Q) for t in (Bm, Cm)]
    B, nc = args[0].shape[:2]
    gen = torch.Generator(cuda_device).manual_seed(16)
    dy = torch.randn((B, nc, Q, H, P), generator=gen, device=cuda_device
                     ).to(dtype)
    dstates = torch.randn((B, nc, H, N, P), generator=gen, device=cuda_device)
    dgamma = torch.randn((B, nc, H), generator=gen, device=cuda_device)
    first = ssd.ssd_chunk_bwd(*args, dy, dstates, dgamma)
    second = ssd.ssd_chunk_bwd(*args, dy, dstates, dgamma)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32))


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("L,H,P,N,chunk", SSD_GRID[:3] + [SSD_GRID[4]])
def test_ssd_scan_grads_match_sequential_ref(cuda_device, L, H, P, N, chunk,
                                             with_init):
    """Autograd through ops.ssd_scan (K4 forward, K5 backward, the
    recurrence in torch ops) against autograd through ssd_ref."""
    from repro_torch.kernels import ref
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, L, H, P, N, 12, True)
    rng = np.random.default_rng(13)
    cot_y, cot_s, s0 = (torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).to(cuda_device)
        for s in ((2, L, H, P), (2, H, P, N), (2, H, P, N)))

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, dt, A, Bm[:, :, :1], Cm[:, :, :1])]
        init = s0.clone().requires_grad_(True) if with_init else None
        y, s = fn(*leaves[:3], *(t.expand(-1, -1, H, -1) for t in leaves[3:]),
                  initial_state=init)
        ((y * cot_y).sum() + (s * cot_s).sum()).backward()
        return [t.grad for t in leaves] + ([init.grad] if with_init else [])

    before = ssd.ssd_chunk_bwd.launches
    got = grads(lambda *a, **k: ops.ssd_scan(*a, chunk=chunk, **k))
    assert ssd.ssd_chunk_bwd.launches == before + 1
    for g, w in zip(got, grads(ref.ssd_ref)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_reduced_training_through_k5_matches_chunked(cuda_device, arch):
    """Reduced mamba2/zamba2 in f32: the loss and every gradient through K4
    + K5 against the plain chunked scan (summation order only), and one
    train step launches K4 twice (remat) and K5 once per layer."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.models import params as pr
    from repro_torch.train.trainer import make_train_step
    cfg = reduced_config(ARCHS[arch])
    params = build_model(cfg).init(torch.Generator(cuda_device).manual_seed(0))
    toks = {"tokens": torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, size=(2, 40))).to(cuda_device)}
    leaves = [t.requires_grad_(True) for t in pr.leaves(params)]
    out = {}
    for impl in ("kernel", "chunked"):
        loss, _ = build_model(cfg, ssd_impl=impl).loss_fn(params, toks)
        out[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
    assert out["kernel"][0] == pytest.approx(out["chunked"][0], rel=1e-5)
    for gk, gc in zip(out["kernel"][1], out["chunked"][1]):
        assert ((gk - gc).abs().max() <= 1e-4 * gc.abs().max()).item()
    for t in leaves:
        t.requires_grad_(False)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 40, 2, "train"))
    step, *_, opt_init = make_train_step(build_model(cfg, ssd_impl="kernel"),
                                         run)
    before = ssd.ssd_chunk.launches, ssd.ssd_chunk_bwd.launches
    params = pr.tree_map(lambda t: t.detach().bfloat16(), params)
    _, _, metrics = step(params, opt_init(params), toks)
    assert np.isfinite(float(metrics["loss"]))
    assert (ssd.ssd_chunk.launches - before[0],
            ssd.ssd_chunk_bwd.launches - before[1]) == (2 * cfg.n_layers,
                                                        cfg.n_layers)


def test_flash_kernel_refuses_to_drop_a_gradient(cuda_device):
    q = torch.randn((1, 4, 16, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_bhsd(q, q, q, causal=True)
    with torch.no_grad():
        fa.flash_attention_bhsd(q, q, q, causal=True)


# ------------------------------------------- K3, K4, K5 as custom ops
def _counts():
    return (fa.flash_attention_bhsd.launches, ssd.ssd_chunk.launches,
            ssd.ssd_chunk_bwd.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_on_the_card_match_plain(cuda_device, dtype):
    """The ops called directly, as a captured graph calls them: the CUDA
    implementations launch the kernels (the counters move by one each) and
    hold the plain versions at the tolerances above; B and C go in as a
    stride-0 head broadcast."""
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               .to(cuda_device, dtype).transpose(1, 2)
               for sh in ((2, 300, 8, 64), (2, 300, 2, 64), (2, 300, 2, 64)))
    before = _counts()
    got = torch.ops.repro_torch.flash_attention(q, k, v, True, 128, 128)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    assert got.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, 512, 4, 64, 128, 22, True,
                                   dtype)
    args = [_chunks(t, 256) for t in (x, dt)] + [A] \
        + [_chunks(t, 256) for t in (Bm, Cm)]
    assert args[3].stride(3) == 0
    got = torch.ops.repro_torch.ssd_chunk_fwd(*args)
    want = ssd.ssd_chunk_plain(*args)
    for g, w, tol in zip(got, want, (SSD_TOL[dtype], SSD_TOL[torch.float32],
                                     SSD_TOL[torch.float32])):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=tol, atol=tol)
    B, nc = args[0].shape[:2]
    dy = torch.from_numpy(rng.standard_normal(
        (B, nc, 256, 4, 64), dtype=np.float32)).to(cuda_device, dtype)
    dstates = torch.from_numpy(rng.standard_normal(
        (B, nc, 4, 128, 64), dtype=np.float32)).to(cuda_device)
    dgamma = torch.from_numpy(rng.standard_normal(
        (B, nc, 4), dtype=np.float32)).to(cuda_device)
    got = torch.ops.repro_torch.ssd_chunk_bwd(*args, dy, dstates, dgamma)
    want = ssd.ssd_chunk_bwd_plain(*args, dy, dstates, dgamma)
    exact = ssd.ssd_chunk_bwd_plain(*(t.double() for t in (
        *args, dy, dstates, dgamma)))
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before)
    for i, (g, w, e) in enumerate(zip(got, want, exact)):
        g, w, e = (t.double().cpu().numpy() for t in (g, w, e))
        if i == 0 and dtype == torch.bfloat16:
            tol = 2e-2 * (1 + np.abs(w))
        else:
            group = {4: (0, 1), 1: (2,)}.get(i, (2, 4))
            tol = (1e-3 * (1 + np.abs(e))
                   + 1e-4 * np.abs(e).max(group, keepdims=True))
        assert (np.abs(g - w) <= 2 * tol).all(), i


def test_custom_ops_pass_opcheck_on_the_card(cuda_device):
    """Schema, fake implementations (K3's output laid out (B, S, H, D) on
    the card), autograd registration and AOT dispatch of the CUDA
    implementations."""
    gen = torch.Generator(cuda_device).manual_seed(23)
    q = torch.randn((1, 4, 128, 64), generator=gen, device=cuda_device
                    ).bfloat16()
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                          (q, q[:, :2], q[:, :2], True, 128, 128))
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, 256, 4, 64, 64, 24, True)
    args = [_chunks(t, 128) for t in (x, dt)] + [A] \
        + [_chunks(t, 128) for t in (Bm, Cm)]
    torch.library.opcheck(torch.ops.repro_torch.ssd_chunk_fwd.default, args)
    B, nc = args[0].shape[:2]
    dy = torch.randn(args[0].shape, generator=gen, device=cuda_device)
    dstates = torch.randn((B, nc, 4, 64, 64), generator=gen,
                          device=cuda_device)
    dgamma = torch.randn((B, nc, 4), generator=gen, device=cuda_device)
    torch.library.opcheck(torch.ops.repro_torch.ssd_chunk_bwd.default,
                          (*args, dy, dstates, dgamma))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_capture_on_the_card_has_one_custom_call_per_launch(cuda_device,
                                                            arch):
    """A reduced kernel-path train step and prefill on the card: the
    capture (fake tensors) launches nothing and holds one custom call per
    launch that the eager run counts."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.core import aten
    from repro_torch.train.trainer import make_train_step
    cfg = reduced_config(ARCHS[arch])
    model = build_model(cfg, ssd_impl="kernel")
    params = model.init(torch.Generator(cuda_device).manual_seed(0),
                        dtype=torch.bfloat16)
    toks = {"tokens": torch.from_numpy(np.random.default_rng(25).integers(
        0, cfg.vocab_size, size=(2, 64))).to(cuda_device)}
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 2, "train"))
    step, *_, opt_init = make_train_step(model, run)
    flash = build_model(cfg, attn_impl="flash", ssd_impl="kernel")

    def prefill(p, b):
        with torch.no_grad():
            return flash.prefill_fn(p, b)

    for fn, args in ((step, (params, opt_init(params), toks)),
                     (prefill, (params, toks))):
        before = _counts()
        fn(*args)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(_counts(), before))
        prog = aten.parse_graph(aten.capture(fn, *args))
        assert _counts() == tuple(a + b for a, b in zip(before, launched))
        calls = [0, 0, 0]
        for o in prog.ops:
            if o.opcode == "custom-call":
                calls[["flash_attention", "ssd_chunk_fwd",
                       "ssd_chunk_bwd"].index(o.name.rstrip("_0123456789"))
                      ] += 1
        assert tuple(calls) == launched and sum(launched) > 0


def _stream_inputs(device, name, n, seed):
    """x1, x2, y0 on the card, distributed as the reference's kernel test."""
    fn, n_in, din, dout = stream.EXPRS[name]
    rng = np.random.default_rng(seed)
    if din == "i4":
        x1 = torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32))
    else:
        x1 = torch.from_numpy(np.abs(rng.standard_normal(n)) + 0.5).to(
            stream.DTYPES[din])
    x2 = torch.from_numpy(np.abs(rng.standard_normal(n)) + 0.5).to(
        stream.DTYPES["f8" if din == "i4" else din])
    y0 = torch.zeros(n, dtype=stream.DTYPES[dout])
    return [t.to(device) for t in (x1, x2, y0)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [4096, 3 * 2**20, 1, 3, 4097, 2**20 + 5])
@pytest.mark.parametrize("name", list(stream.EXPRS))
def test_elementwise_kernel_matches_plain(cuda_device, name, n, offset):
    """0 elements differ from the plain version: offset 0 takes the vector
    path (and the scalar tail past the last whole tile), offset 1 (views
    one element into their buffers, not 16-byte aligned) the scalar path."""
    args = [t[offset:] for t in _stream_inputs(cuda_device, name, n + offset,
                                               seed=n + len(name))]
    before = stream.elementwise.launches
    got = stream.elementwise(name, *args, block=n)
    torch.cuda.synchronize()
    assert stream.elementwise.launches == before + 1
    want = stream.elementwise_plain(name, *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [2**20, 1, 3, 4097, 2**20 + 5])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_fit_entries_match_plain(cuda_device, dtype, tol, n, offset):
    """fill is exact; poly16 runs each Horner step as one FMA where the
    plain version rounds a product and a sum, so it is held at tol; both
    paths, as above."""
    x = (torch.rand(n + offset, device=cuda_device, dtype=torch.float64)
         * 0.1 + 0.5).to(dtype)[offset:]
    torch.testing.assert_close(stream.elementwise("poly16", x, block=n),
                               stream.elementwise_plain("poly16", x),
                               rtol=tol, atol=tol)
    z = stream.elementwise("fill", x, block=n)
    assert z.dtype == dtype and z.shape == x.shape and not z.any()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("max_ctas", [1, 2, 4, 8, 16, 33, 66, 132, None])
@pytest.mark.parametrize("n", [184 * 8192, 1 << 22, 37 * 8192, 5000])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, 1e-6)),
                                       (torch.float64, (1e-12, 1e-12))])
def test_stream_triad_kernel_matches_plain(cuda_device, dtype, tol, n,
                                           max_ctas, offset):
    """Offset 0 takes the vector path (and the scalar tail), offset 1 (views
    one element into their buffers, not 16-byte aligned) the scalar path;
    in f64 0 elements differ from the plain version."""
    rng = np.random.default_rng(n)
    a, b = (torch.from_numpy(rng.standard_normal(n + offset)).to(
        cuda_device, dtype)[offset:] for _ in range(2))
    got = stream.stream_triad(a, b, 3.0, max_ctas=max_ctas)
    torch.cuda.synchronize()
    want = stream.stream_triad_plain(a, b, 3.0)
    torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])
    if dtype == torch.float64:
        assert int((got != want).sum()) == 0


def test_stream_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.ones(4096, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        stream.elementwise("add", x.float(), x.float())
    with pytest.raises(ValueError, match="contiguous"):
        stream.elementwise("add", x[::2].repeat(2)[::2], x[:2048])
    with pytest.raises(ValueError, match="contiguous"):
        stream.stream_triad(x.view(64, 64), x.view(64, 64))
    with pytest.raises(TypeError):
        stream.stream_triad(x.int(), x.int())


# ------------------------------------------------ the scheduler's scan
def _scan_case(seed, n, cores, partition, M, hub=0):
    """A random DAG (``hub`` extra ops, costed and free in turn, each
    reading every earlier op: more edges than the kernel stages at once),
    its batch form on ``cores``
    cores of the A64FX node, and M random knob combos and duration
    columns; the kernel's inputs on the card and the plain version's on
    the CPU, and the NumPy pass's result."""
    import random

    from _sched_dags import random_program

    from repro_torch.core import hlo, hwspec, node
    from repro_torch.core.compiled import O3Knobs
    prog = random_program(random.Random(seed), n, hlo)
    for h in range(hub):
        i = len(prog.ops)
        prog.ops.append(hlo.OpStat(f"hub{h}", "tuple" if h % 2 else "fusion",
                                   "other" if h % 2 else "data", "f32",
                                   bytes_accessed=1e6,
                                   read_bytes=5e5, write_bytes=5e5,
                                   deps=list(range(i)), dep_bytes=[1.0] * i))
    nc = node.compile_node(prog, hwspec.A64FX_CORE)
    nb = node.compile_node_batch(nc, hwspec.A64FX_CORE, cores,
                                 hwspec.A64FX_NODE, partition)
    rng = np.random.default_rng(seed)
    knobs = O3Knobs(window=rng.choice([1, 2, 4, 7, 64, 256, 1024], M),
                    width=rng.integers(1, 5, (M, 4)),
                    depth=rng.integers(1, 65, (M, 4)))
    durs = nc.cp.durations[:, None] * rng.uniform(0.5, 2.0, (1, M))
    want = node._node_pass_batch(nb, durs, knobs.window, knobs.width,
                                 knobs.depth)
    return nb, knobs, durs, want


@pytest.mark.parametrize("cores,partition", [(1, "shard"), (4, "round-robin"),
                                             (48, "round-robin"),
                                             (48, "graph")])
@pytest.mark.parametrize("M", [1, 33, 90, 1000])
def test_sched_scan_kernel_matches_plain(cuda_device, cores, partition, M):
    """Bit for bit against the plain version and the NumPy pass: S = 1, 4
    and 48 streams, windows up to 1024, depths to 64, M from 1 to 1000; at
    48 cores the cross-CMG ring addend is on."""
    from repro_torch.core import node
    from repro_torch.kernels import sched_scan
    nb, knobs, durs, want = _scan_case(cores + M, 1100, cores, partition, M,
                                       hub=2)
    assert (nb.edge_extra is not None) == (cores == 48)
    before = sched_scan.node_scan.launches
    got = sched_scan.node_scan(
        node.scan_structure(nb, cuda_device),
        torch.from_numpy(durs).to(cuda_device),
        *sched_scan.knob_tensors(knobs.window, knobs.width, knobs.depth,
                                 cuda_device))
    torch.cuda.synchronize()
    assert sched_scan.node_scan.launches == before + 1
    plain = sched_scan.node_scan_plain(
        node.scan_structure(nb, "cpu"), torch.from_numpy(durs),
        *sched_scan.knob_tensors(knobs.window, knobs.width, knobs.depth,
                                 "cpu"))
    assert torch.equal(got.cpu(), plain)
    assert np.array_equal(got.cpu().numpy(), want)


def test_sched_scan_backends_on_the_card_equal_numpy(cuda_device):
    """``backend="torch"`` on the card: ``schedule_batch`` and the node
    engines' fixpoints (48 streams with the ring addend, the shard sweep)
    give NumPy's bits, and launch the kernel."""
    import random

    from _sched_dags import random_program

    from repro_torch.core import compiled, hlo, hwspec, node
    from repro_torch.kernels import sched_scan
    prog = random_program(random.Random(7), 600, hlo)
    grid = compiled.O3Knobs.from_grid(
        hwspec.A64FX_CORE, [(w, mw, vw, qd) for w in (4, 16, 64, 256, 1024)
                            for mw in (1, 2, 4) for vw in (1, 2)
                            for qd in (4, 16, 64)])
    before = sched_scan.node_scan.launches
    cp = compiled.compile_program(prog, hwspec.CPU_HOST)
    assert np.array_equal(
        compiled.schedule_batch(cp, grid, "torch", cuda_device),
        compiled.schedule_batch(cp, grid))
    nc = node.compile_node(prog, hwspec.A64FX_CORE)
    for part in ("round-robin", "graph"):
        args = (nc, hwspec.A64FX_CORE, grid, 48, hwspec.A64FX_NODE, part)
        a = node.schedule_node_batch(*args)
        b = node.schedule_node_batch(*args, backend="torch",
                                     device=cuda_device)
        assert np.array_equal(a.t_est, b.t_est)
        assert np.array_equal(a.iterations, b.iterations)
    args = (nc, hwspec.A64FX_CORE, grid, (12, 48), hwspec.A64FX_NODE)
    assert np.array_equal(node.schedule_node_sweep(*args),
                          node.schedule_node_sweep(*args, backend="torch",
                                                   device=cuda_device))
    assert sched_scan.node_scan.launches > before + 3


def test_sampled_node_sweep_on_the_card_equals_numpy(cuda_device):
    """``sample.sampled_node_sweep(backend="torch")``: each
    representative's core-count x knob sweep through the scan on the card,
    NumPy's bits, the kernel launched."""
    import random

    from _sched_dags import random_program

    from repro_torch.core import hlo, hwspec, sample, zoo
    from repro_torch.kernels import sched_scan
    step = random_program(random.Random(11), 300, hlo)
    prog = sample.unroll_program(step, 6)
    knobs = zoo.zoo_o3_knobs(hwspec.A64FX_CORE)
    plan = sample.sample_program(
        prog, hwspec.A64FX_CORE,
        sample.SamplingConfig(interval_ops=100.0, k=4), "f32")
    args = (prog, hwspec.A64FX_CORE, knobs, (1, 12, 48), hwspec.A64FX_NODE)
    want, _ = sample.sampled_node_sweep(*args, plan=plan)
    before = sched_scan.node_scan.launches
    got, _ = sample.sampled_node_sweep(*args, plan=plan, backend="torch",
                                       device=cuda_device)
    assert sched_scan.node_scan.launches > before
    assert got.shape == (3, 12) and np.array_equal(got, want)


def test_zoo_cell_on_the_card_equals_numpy(cuda_device):
    """One zoo cell (reduced chatglm3-6b's decode step, captured over fake
    CPU tensors) with its O3 grid on the card, NumPy's bits."""
    from repro_torch.core import zoo
    from repro_torch.kernels import sched_scan
    kw = dict(models=["chatglm3-6b"], phases=["decode"])
    want = zoo.run_zoo(**kw).to_dict()
    before = sched_scan.node_scan.launches
    got = zoo.run_zoo(backend="torch", device=cuda_device, **kw).to_dict()
    assert sched_scan.node_scan.launches > before
    assert got["models"] == want["models"]


def test_pointer_chase_times_a_load(cuda_device):
    from repro_torch.kernels import sched_scan
    shared = sched_scan.pointer_chase_ns("shared", cuda_device, hops=1 << 14)
    l2 = sched_scan.pointer_chase_ns("l2", cuda_device, hops=1 << 12)
    assert 1 < shared < l2 < 5000
