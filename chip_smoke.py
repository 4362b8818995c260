#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and calibration paths on one
NVIDIA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card: ``nvidia-smi`` name and power limit, torch's device name, count;
2. the build: ``nvcc`` builds every kernel of the paths from ``src/`` (K1
   and K2 in ``stream.cu``, K3, K4 and K5), one compiler per source, all
   started together (seconds, ptxas register, shared-memory and spill
   lines; K3's dynamic shared memory a CTA for each head dim);
3. kernel vs plain: each kernel against its plain PyTorch version on the card:
   flash attention (K3) at the unit-test grid, its tile edges (Sq, Sk of
   127-129 and 2047, G = 16 and 1, every head dim) and the chatglm3-6b and
   zamba2-1.2b prefill shapes on (B, S, H, D) views;
   the SSD chunk kernel (K4) at the reference's grid, a Q < chunk case and the
   mamba2-1.3b and zamba2-1.2b prefill shapes, f32 and bf16, B/C contiguous
   and head-broadcast, then ``ops.ssd_scan`` with ``initial_state`` against
   the split-sequence identity; the SSD backward kernel (K5) against its
   plain version and both against the same math in f64, at the same grid
   and the mamba2-1.3b and zamba2-1.2b training shapes; and the gradient
   of ``ops.ssd_scan`` (K4 + K5) against autograd through the sequential
   ``ssd_ref``, with and without ``initial_state``; the Table-1 kernel (K1)
   on all 28 expressions at n = 4096 and at the accuracy table's n, at
   every size the fit of phase 15 runs it, and on both of its paths (16-byte
   aligned and one element off) at n = 1, 3, 4097 and 2^20 + 5, 0 elements
   differing from plain for the 28; and STREAM Triad (K2) in f32 and
   f64 at every CTA cap and size of phase 17, against their plain versions,
   with the count of elements that are not bit-identical;
4. full-width serving of chatglm3-6b (6.24 B parameters, bf16, weights from a
   seeded generator, ``attn_impl="flash"``): 4 requests of 128, 512, 1024 and
   2048 prompt tokens and 32 new tokens each, one ``ServeEngine.generate``
   call each; the flash kernel must launch once per layer and request, and
   every token must be in range;
5. model-level cross-check: the 1024-token prefill through the kernel
   (``flash``) against plain PyTorch (``blocked``), last-position logits;
6. timing: the flash kernel at chatglm3-6b's and zamba2-1.2b's attention
   shapes, S = 2048 and 512, on device time (each call behind a
   device-side spin) beside its bound, the plain version and
   ``scaled_dot_product_attention`` (timed here only; the port never calls
   it);
7. full-width serving of mamba2-1.3b (1.34 B parameters, 48 layers, bf16,
   ``ssd_impl="kernel"``): 4 requests of 128, 512, 1000 and 2048 prompt
   tokens and 32 new tokens each; K4 must launch 48 x 4 = 192 times;
8. full-width serving of zamba2-1.2b (1.15 B parameters, 38 Mamba2 layers
   and a shared attention block run 7 times): 2 requests of 512 and 2048
   tokens and 16 new tokens each; K4 must launch 76 times and K3 14 times;
9. model-level cross-check: the 1000-token prefill of mamba2-1.3b and of
   zamba2-1.2b through K4 (``kernel``) against plain PyTorch (``chunked``)
   with the same weights in f32, the kernel path in f32 and in bf16, and
   the same argmax;
10. timing: K4 at mamba2-1.3b's 2048-token prefill shape (CUDA events)
    beside its bound and its plain version (no single PyTorch call computes
    this function);
11. full-width training of mamba2-1.3b through ``launch.train.train_loop``
    (``RunConfig`` defaults: bf16 parameters and compute, f32 AdamW, remat
    full; ``ssd_impl="kernel"``): 5 steps of 4 x 2048 synthetic tokens; K4
    must launch 96 times a step (forward and its recompute) and K5 48
    times; every loss finite, and batch 0's loss lower after the steps than
    before; step ms, tokens/s, peak memory, and the profiler's view of one
    more step;
12. the same for zamba2-1.2b: 3 steps of 2 x 2048 tokens; K4 76 and K5 38
    launches a step; the shared attention runs ``blocked`` and K3 must
    launch 0 times;
13. gradient cross-check at full width in f32: mamba2-1.3b on one
    1000-token sequence, the K4 + K5 path against ``ssd_impl="chunked"``
    with the same weights: the losses within 1e-4 relative, every gradient
    leaf within 1e-3 of its largest |g|;
14. timing: K5 at mamba2-1.3b's training shape beside its bound and its
    plain version (no single PyTorch call computes this function);
15. the paper's calibration loop (``repro_torch.core.calibrate``): fit the
    H100 spec from K1 microbenchmarks and print every fitted scalar;
16. the Fig. 3 accuracy tables, all 28 Table-1 kernels timed through K1
    and simulated, at Table 1's n x 1024 and x 16384 (HBM-resident), K1's
    launches counted (28 x (1 + repeats) each), and the O3 sweep's top 8;
17. the Figs. 4/5 Triad sweep: K2 at 1-132 CTAs, at ~3/4 of the L2 and at
    twice it, measured against the saturating-bandwidth model;
18. timing: each K1 expression at the HBM-resident scale and K2 at twice
    the L2, beside the plain version, one PyTorch call where one computes
    the function, and the bound (bytes over 3.35 TB/s, f64 flops counted in
    the SASS over 34 TFLOP/s); each output at these shapes held against the
    plain version's, as in phase 3.

After each model's serving phase, the profiler's kernel time of one prefill
of its longest prompt (with each kernel's share) and of 8 decode steps, beside
the host clock and the device's idle share.
Each serving and training phase sets every kernel's launch count to 0 just
before it and reads the counts just after; so does the calibration path
for K1 and K2.  Then one ``{"kernels": [...]}`` line and, last,
the ``{"ok": true, ...}`` line.  There is no CPU path: without a CUDA device
the script exits with 1.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "chatglm3-6b"
PROMPT_LENS = (128, 512, 1024, 2048)
NEW_TOKENS = 32
TIMING_S = 2048
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12         # CUDA-core FMAs, the rate K4's design uses
HBM_BYTES_PER_S = 3.35e12
KERNELS = ("flash_attention", "ssd_scan", "ssd_scan_bwd")  # model paths
SOURCES = (*KERNELS, "stream")        # csrc/*.cu, built side by side
KERNEL_FUNCTIONS = {"flash_attention": "flash_fwd_",   # CUDA function names
                    "ssd_scan": "ssd_chunk_fwd", "ssd_scan_bwd": "ssd_bwd_"}
CUBLAS_FUNCTIONS = ("gemm", "nvjet", "xmma", "cutlass")  # library matmuls
# kernel vs plain: the reference's own kernel-test tolerances
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# flash vs blocked logits after 28 bf16 layers, relative to the largest
# logit; the K4 path in bf16 may be that much further from the chunked scan in
# f32 than the chunked scan in bf16 is; 1e-3 for the K4 path against the
# chunked scan with both in f32 (summation order only)
XCHECK_TOL = 2e-2
XCHECK_F32_TOL = 1e-3
UNIT_GRID = [  # (B, Sq, Sk, H, KVH, D): the reference's grid, then D=256, 128
    (2, 128, 128, 4, 4, 64), (2, 256, 256, 4, 1, 64), (2, 128, 384, 8, 2, 32),
    (2, 100, 200, 4, 2, 64), (1, 300, 170, 8, 2, 256), (1, 200, 333, 4, 2, 128)]
# the bf16 kernel's tile edges (128 query rows a CTA, 128 keys a block, 64
# at D = 256): Sq, Sk in 127-129 and 2047, Sq != Sk, G = 16 and 1, every D
UNIT_GRID += [(1, sq, sk, h, kvh, d) for d in (32, 64, 128, 256)
              for sq, sk, h, kvh in ((127, 127, 16, 1), (128, 129, 4, 4),
                                     (129, 128, 16, 1), (2047, 2047, 2, 2),
                                     (127, 2047, 16, 1), (2047, 129, 16, 16))]
# K3 timing: chatglm3-6b's and zamba2-1.2b's attention at S = 2048 and 512:
# (label, H, KVH, D, S)
FLASH_TIMING = [("chatglm3-6b", 32, 2, 128, 2048), ("zamba2-1.2b", 32, 32, 64, 2048),
                ("chatglm3-6b", 32, 2, 128, 512), ("zamba2-1.2b", 32, 32, 64, 512)]
FLASH_REPEATS = 30
# K4 vs plain: f32 outputs (y_diag from f32 inputs, states, gamma) at 1e-3:
# both compute in f32, but the kernel's cumsum is a warp scan and its dot
# products sum in another order, and at Q = 256 with the reference test's
# dt and A, cs reaches ~-230, where one f32 step is 1.5e-5; the two cs then
# differ by ~1e-4, so exp(cs_i - cs_j) and y of magnitude ~10 differ by
# ~1e-3 (1.05e-3 seen on the card).  y_diag from bf16 inputs is stored in
# bf16: 2e-2.  Relative and absolute alike: |err| <= tol + tol|plain|.
SSD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
SSD_F32_TOL = 1e-3
SSD_GRID = [  # (B, L, H, P, N, chunk): the reference's grid, Q < chunk, the
    (2, 64, 2, 16, 16, 16), (2, 128, 4, 32, 32, 32),   # models' prefill shapes
    (2, 96, 2, 16, 8, 32), (2, 100, 4, 64, 128, 256),
    (1, 2048, 64, 64, 128, 256), (1, 2048, 64, 64, 64, 256)]
SSD_SCAN_TOL = 2e-3          # ops.ssd_scan identities, the reference's own
# K5: the kernel and its plain version each against the same math in f64
# (ssd_chunk_bwd_plain on f64 inputs).  dx stored in bf16: |err| <= 2e-2 +
# 2e-2|f64|.  f32 outputs: 1e-3 + 1e-3|f64| (K4's reason) plus 1e-4 of the
# largest |f64| among the values that share the error's source: the (batch,
# chunk, head) cell for dx, ddt, dB and dC, and for da the head's values
# over batch and chunks, which the autograd Function sums into dA[h].  At
# Q = 256 cs reaches ~-230, where one f32 step is 1.5e-5, so each
# exp(cs_i - cs_j) of any f32 evaluation is ~1e-4 off; ddt, dB and da come
# out of sums whose terms cancel (row minus column sums of dM∘M, their
# reverse cumsum), so that error lands at the scale of the cell's largest
# value, not of each small one.  The kernel against the plain version: twice
# that, with the plain version as the reference (each is within the
# tolerance of f64, so the two are within twice it of each other).
SSD_BWD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
SSD_BWD_GROUP_TOL = 1e-4
SSD_BWD_GRID = SSD_GRID[:4] + [  # the training shapes: batch 4, nc 8
    (4, 2048, 64, 64, 128, 256), (4, 2048, 64, 64, 64, 256)]
TRAIN_SEQ = 2048
SSM_TRAIN_BATCH, SSM_TRAIN_STEPS = 4, 5
HYBRID_TRAIN_BATCH, HYBRID_TRAIN_STEPS = 2, 3
# f32 gradients through K4 + K5 against the chunked scan: summation order
# only (fixed before the first run)
XGRAD_LOSS_TOL, XGRAD_TOL, XGRAD_TOKENS = 1e-4, 1e-3, 1000
SSM_ARCH, HYBRID_ARCH = "mamba2-1.3b", "zamba2-1.2b"
SSM_PROMPT_LENS = (128, 512, 1000, 2048)
HYBRID_PROMPT_LENS = (512, 2048)
HYBRID_NEW_TOKENS = 16
PEAK_F64_FLOPS = 34e12         # CUDA-core f64 (NVIDIA data sheet, SXM)
# K1 vs plain: the reference's tolerance (tests/test_kernels.py:126-128),
# |err| <= 1e-12 + 1e-12|plain|; poly16 in f32 at 1e-5 (the kernel fuses
# each Horner step into one FMA, the plain version rounds twice).  K2: the
# reference's f32 tolerance, rtol 1e-5 and atol 1e-6, and 1e-12 in f64.
STREAM_TOL, POLY16_F32_TOL = 1e-12, 1e-5
TRIAD_TOL = {"float32": (1e-5, 1e-6), "float64": (1e-12, 1e-12)}
STREAM_CHECK_N = 4096
K1_EDGE_NS = (1, 3, 4097, (1 << 20) + 5)   # K1's tails: no whole tile, ragged
HBM_SCALE = 16384              # Table 1's n x 16384: 256-512 MB f64 arrays
STREAM_ITERS = 20
# Triad (Figs. 4/5): about 3/4 of the 50 MB L2 and twice it, in f64
TRIAD_L2_N, TRIAD_MEM_N = 184 * 8192, 1 << 22
TRIAD_CTAS = (1, 2, 4, 8, 16, 33, 66, 132)
# K2 checks: both sweep sizes; 37 x 8192, no multiple of the full grid (264
# CTAs of 1024 threads) nor of 33 or 132 CTAs; 5000, no multiple of any grid;
# every cap of the sweep and the full grid
TRIAD_CHECK_NS = (TRIAD_L2_N, TRIAD_MEM_N, 37 * 8192, 5000)
TRIAD_CHECK_CTAS = (*TRIAD_CTAS, None)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def time_ms(fn, iters, warmup=3):
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``iters`` calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


# ------------------------------------------------- K1, K2 and the calibration
def compare_stream(what, got, want, rtol, atol, exact=False):
    """K1 or K2 against its plain version: (max |err|, the largest share of
    the tolerance |err| <= atol + rtol|plain| used, elements that are not
    bit-identical).  Fails on a shape or dtype mismatch, on non-finite
    output, where the tolerance is exceeded, or, if ``exact``, where any
    element differs."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: kernel {tuple(got.shape)} {got.dtype}, plain "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    err = diff.max().item()
    used = (diff / (atol + rtol * w.abs())).max().item() if atol else (
        0.0 if err == 0 else float("inf"))
    if used > 1 or not torch.isfinite(g).all():
        fail(f"{what} disagrees with its plain version: max|err| {err:.3e}")
    differ = int((got != want).sum().item())
    if exact and differ:
        fail(f"{what}: {differ} elements differ from the plain version")
    return err, used, differ


def check_stream(dev) -> dict:
    """K1 and K2 against their plain versions on the card (phase 3f).

    K1: all 28 Table-1 expressions in their dtypes, inputs distributed as
    the reference's (``calibrate._kernel_inputs``), at n = 4096 (the
    reference test's size) and at the accuracy table's n (Table 1's n x
    1024); ``add`` also at ``fit_h100``'s sizes (one block, N_L2, N_HBM);
    then the fit entries ``poly16`` (f64, f32) at N_L2 and ``fill`` at
    N_HBM, as ``fit_h100`` runs them.  (The HBM-resident table's n is held
    in :func:`time_stream`.)  K2: f32 and f64 at every cap in
    TRIAD_CHECK_CTAS, at both sweep sizes and at n that are no multiple of
    the grid.  Prints the elements that are not bit-identical.  Returns the
    largest errors and shares of the tolerance."""
    import torch

    from repro_torch.configs.a64fx_kernelsuite import KERNELS as SUITE
    from repro_torch.core import calibrate as cal
    from repro_torch.kernels import stream

    gen = torch.Generator(device=dev).manual_seed(1)
    fit_ns = {"add": (2048, cal.N_L2, cal.N_HBM)}    # fit_h100's add launches
    k1_err = k1_used = 0.0
    for k in SUITE:
        line = []
        for n in (STREAM_CHECK_N, k.n * cal.SIZE_SCALE,
                  *fit_ns.get(k.name, ())):
            x1, x2, y0 = cal._kernel_inputs(k, n, gen, dev)
            got = stream.elementwise(k.name, x1, x2, y0)
            torch.cuda.synchronize()
            want = stream.elementwise_plain(k.name, x1, x2, y0)
            err, used, differ = compare_stream(f"K1 {k.name} n={n}", got,
                                               want, STREAM_TOL, STREAM_TOL,
                                               exact=True)
            k1_err, k1_used = max(k1_err, err), max(k1_used, used)
            line.append(f"n={n}: max|err| {err:.3e}, {differ} of {n} not "
                        f"bit-identical, {used:.1%} of the tolerance")
            del x1, x2, y0, got, want
        print(f"[check] K1 {k.name} ({k.ktype}): " + "; ".join(line))
    # both of K1's paths and its tails: lengths with and without a ragged
    # tile (1024 elements), views one element off 16-byte alignment (the
    # scalar path); 0 elements may differ
    for k in SUITE:
        line = []
        for n in K1_EDGE_NS:
            for offset in (0, 1):
                x1, x2, y0 = (t[offset:] for t in cal._kernel_inputs(
                    k, n + offset, gen, dev))
                got = stream.elementwise(k.name, x1, x2, y0, block=n)
                torch.cuda.synchronize()
                err, used, _ = compare_stream(
                    f"K1 {k.name} n={n} offset={offset}", got,
                    stream.elementwise_plain(k.name, x1, x2, y0), STREAM_TOL,
                    STREAM_TOL, exact=True)
                k1_err, k1_used = max(k1_err, err), max(k1_used, used)
                line.append(f"{n}/{offset}")
        print(f"[check] K1 {k.name} bit-identical at n/offset "
              + ", ".join(line))
    for name, dtype, tol in (("poly16", torch.float64, STREAM_TOL),
                             ("poly16", torch.float32, POLY16_F32_TOL),
                             ("fill", torch.float64, 0.0),
                             ("fill", torch.float32, 0.0)):
        for n in K1_EDGE_NS:
            for offset in (0, 1):
                x = (torch.rand(n + offset, generator=gen, device=dev,
                                dtype=torch.float64) * 0.1 + 0.5).to(
                    dtype)[offset:]
                got = stream.elementwise(name, x, block=n)
                torch.cuda.synchronize()
                err, used, _ = compare_stream(
                    f"K1 {name} {dtype} n={n} offset={offset}", got,
                    stream.elementwise_plain(name, x), tol, tol)
                k1_err, k1_used = max(k1_err, err), max(k1_used, used)
        print(f"[check] K1 {name} {dtype} at n {K1_EDGE_NS}, offsets 0 and "
              f"1: within {tol:g} ok")
    # poly16: the kernel fuses each Horner step, the plain version rounds
    # twice; fill is exact
    for name, dtype, tol, n in (
            ("poly16", torch.float64, STREAM_TOL, cal.N_L2),
            ("poly16", torch.float32, POLY16_F32_TOL, cal.N_L2),
            ("fill", torch.float64, 0.0, cal.N_HBM)):
        x = (torch.randn(n, generator=gen, device=dev).abs() * 0.1
             + 0.5).to(dtype)
        got = stream.elementwise(name, x)
        torch.cuda.synchronize()
        err, used, differ = compare_stream(
            f"K1 {name} {dtype} n={n}", got, stream.elementwise_plain(name, x),
            tol, tol)
        k1_err, k1_used = max(k1_err, err), max(k1_used, used)
        print(f"[check] K1 {name} {dtype} n={n}: max|err| {err:.3e}, "
              f"{differ} not bit-identical (tolerance {tol:g}) ok")

    k2_err = k2_used = 0.0
    for dtype, (rtol, atol) in TRIAD_TOL.items():
        for n in TRIAD_CHECK_NS:
            a = torch.randn(n, generator=gen, device=dev).to(getattr(torch, dtype))
            b = torch.randn(n, generator=gen, device=dev).to(getattr(torch, dtype))
            want = stream.stream_triad_plain(a, b, 3.0)
            line = []
            for ctas in TRIAD_CHECK_CTAS:
                got = stream.stream_triad(a, b, 3.0, max_ctas=ctas)
                torch.cuda.synchronize()
                err, used, differ = compare_stream(
                    f"K2 {dtype} n={n} max_ctas={ctas}", got, want, rtol,
                    atol)
                k2_err, k2_used = max(k2_err, err), max(k2_used, used)
                line.append(f"{ctas}: {err:.1e}/{differ}")
            print(f"[check] K2 {dtype} n={n} (rtol {rtol:g}, atol {atol:g}), "
                  f"max_ctas: max|err|/elements not bit-identical: "
                  + ", ".join(line) + " ok")
    return {"k1_err": k1_err, "k1_used": k1_used, "k2_err": k2_err,
            "k2_used": k2_used}


def calibrate_h100(dev) -> dict:
    """The paper's calibration loop on the card, the main path of this
    slice: fit the H100 spec from K1 microbenchmarks, both Fig. 3 tables
    (K1's launches counted: kernels x (1 + repeats) each), the O3 sweep,
    and the Triad sweep over CTA caps (Figs. 4/5)."""
    from repro_torch.core import calibrate as cal
    from repro_torch.kernels import stream

    stream.elementwise.launches = stream.stream_triad.launches = 0
    t0 = time.perf_counter()
    hw = cal.fit_h100(dev)
    launches = {"stream_elementwise": stream.elementwise.launches,
                "stream_triad": stream.stream_triad.launches}
    fitted = {"op_startup_ns": hw.op_startup_ns,
              "vpu_flops_f64": hw.vpu_flops["f64"],
              "vpu_flops_f32": hw.vpu_flops["f32"],
              "vmem_bw": hw.vmem_bw, "hbm_read_bw": hw.hbm_read_bw,
              "hbm_write_bw": hw.hbm_write_bw,
              "transcendental_factor": hw.transcendental_factor,
              "dma_overlap": hw.dma_overlap,
              **{f"factor_{op}": hw.opcode_factor[op]
                 for op in (*cal._FACTOR_FIT.values(), "remainder")}}
    print(f"[fit] H100 spec fitted on the card in "
          f"{time.perf_counter() - t0:.2f} s ({launches['stream_elementwise']}"
          f" K1 launches): " + ", ".join(f"{k} {v:.6g}"
                                         for k, v in fitted.items()))
    tables = {}
    for scale in (cal.SIZE_SCALE, HBM_SCALE):
        stream.elementwise.launches = 0
        t0 = time.perf_counter()
        table = cal.kernel_accuracy_table(hw, size_scale=scale,
                                          keep_programs=True, device=dev)
        got = stream.elementwise.launches
        want = len(table.rows) * (1 + cal.REPEATS)
        launches["stream_elementwise"] += got
        print(f"[fig3] kernel accuracy table at size_scale {scale} "
              f"({time.perf_counter() - t0:.2f} s; K1 launches {got}, want "
              f"{want}):")
        print(table.report())
        if got != want:
            fail(f"the table at size_scale {scale} launched K1 {got} times, "
                 f"want {want}")
        sweep = cal.sweep_o3(table, hw)
        print(f"[o3] sweep_o3 over the size_scale {scale} table, top 8:")
        print(sweep.report(8))
        tables[scale] = {
            "rows": [[r.name, r.measured_us, r.simulated_us,
                      r.simulated_sched_us] for r in table.rows],
            "mean_diff": table.mean_diff, "std_diff": table.std_diff,
            "mean_abs_diff": table.mean_abs_diff,
            "within_10pct": table.within_10pct,
            "sched_mean_abs_diff": table.sched_mean_abs_diff,
            "o3_best": sweep.results[0]}
    triad = {}
    stream.stream_triad.launches = 0
    for label, n in (("l2", TRIAD_L2_N), ("mem", TRIAD_MEM_N)):
        rows, fit = cal.triad_scaling(n, TRIAD_CTAS, device=dev)
        print(f"[triad] {label}: n={n} f64, {3 * 8 * n / 1e6:.1f} MB working "
              f"set; fit bw1 {fit['bw1'] / 1e9:.2f} GB/s, plateau "
              f"{fit['plateau'] / 1e9:.2f} GB/s")
        print(f"{'ctas':>8s}{'measured_GB/s':>15s}{'simulated_GB/s':>16s}"
              f"{'diff%':>8s}")
        for r in rows:
            print(f"{r['ctas']:>8d}{r['measured_gbps']:>15.2f}"
                  f"{r['simulated_gbps']:>16.2f}{r['diff_pct']:>8.1f}")
        triad[label] = {"n": n, "fit": fit, "rows": [
            [r["ctas"], r["measured_gbps"], r["simulated_gbps"]]
            for r in rows]}
    launches["stream_triad"] += stream.stream_triad.launches
    want_k2 = 2 * len(TRIAD_CTAS) * (1 + cal.REPEATS)
    print(f"[calibrate] launches on the calibration path: {launches} "
          f"(K2 want {want_k2})")
    if launches["stream_triad"] != want_k2 or not all(launches.values()):
        fail(f"calibration launches {launches}")
    return {"fitted": fitted, "tables": tables, "triad": triad,
            "launches": launches}


F64_FLOPS = {"DFMA": 2, "DADD": 1, "DMUL": 1}   # flops per SASS instruction


def fewest_f64_flops(body: str) -> int:
    """The fewest f64 flops on any path from a function's first instruction
    to an EXIT in its SASS listing: DFMA counts 2, DADD and DMUL 1 (the
    data sheet's 34 TFLOP/s counts an FMA as two).  Branches are followed
    both ways where predicated, calls are stepped over (their body is not
    counted), so this is a lower bound on what one call executes."""
    import heapq
    import re

    instrs, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        instrs.append((addr, m.group(2).strip()))
    index = {addr: i for i, (addr, _) in enumerate(instrs)}
    end = len(instrs)
    graph = []
    for i, (_, text) in enumerate(instrs):
        pred = re.match(r"@!?U?P\w+\s+", text)
        op = text[pred.end():] if pred else text
        opcode = op.split()[0] if op.split() else ""
        base = opcode.split(".")[0]
        succ = []
        if base == "BRA":
            tgt = re.search(r"\((\.L_x_\d+)\)|(0x[0-9a-f]+)", op)
            if tgt:
                addr = labels.get(tgt.group(1)) if tgt.group(1) \
                    else int(tgt.group(2), 16)
                if addr in index:
                    succ.append(index[addr])
            # a guard (@P0 BRA) or a predicate operand (BRA P1, ...) makes
            # the branch conditional
            conditional = pred or re.match(r"BRA\S*\s+!?U?P\w+\s*,", op)
            if conditional and i + 1 < end:
                succ.append(i + 1)
        elif base in ("EXIT", "RET"):
            succ.append(end)
            if pred and i + 1 < end:
                succ.append(i + 1)
        elif i + 1 < end:
            succ.append(i + 1)
        graph.append((F64_FLOPS.get(base, 0), succ))
    best = {0: graph[0][0]} if graph else {}
    heap = [(best.get(0, 0), 0)]
    while heap:
        d, i = heapq.heappop(heap)
        if i == end:
            return d
        if d > best.get(i, float("inf")):
            continue
        for j in graph[i][1]:
            dj = d + (graph[j][0] if j < end else 0)
            if dj < best.get(j, float("inf")):
                best[j] = dj
                heapq.heappush(heap, (dj, j))
    raise ValueError("no path to EXIT in the SASS listing")


def sass_f64_flops(lib_path) -> dict:
    """f64 flops an element of each Table-1 expression, counted in the SASS
    of its ``ops_probe`` instance (``cuobjdump -sass``): the same
    ``apply<E>`` as K1's loop body, one element, compiled alone.  Returns
    name -> (the fewest flops on any path (:func:`fewest_f64_flops`), the
    flops of every instruction in the listing).  The listing is written
    beside the library, with the suffix ``.sass``."""
    import re
    import shutil

    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    tool = next((c for c in cands if c and Path(c).exists()), None)
    if tool is None:
        fail("cuobjdump not found: the K1 op bound needs the kernel's SASS")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    Path(lib_path).with_suffix(".sass").write_text(sass)
    from repro_torch.kernels import stream
    names = list(stream.EXPRS)
    flops = {}
    for chunk in sass.split("Function : ")[1:]:
        head, _, body = chunk.partition("\n")
        m = re.search(r"ops_probeILi(\d+)E", head)
        if m:
            every = sum(F64_FLOPS[op] * len(re.findall(rf"\b{op}\b", body))
                        for op in F64_FLOPS)
            flops[names[int(m.group(1))]] = (fewest_f64_flops(body), every)
    if set(flops) != set(names):
        fail(f"no ops_probe SASS for {sorted(set(names) - set(flops))}")
    return flops


def time_stream(dev, lib_path) -> dict:
    """K1 at the HBM-resident scale (Table 1's n x HBM_SCALE), each of the 28
    expressions beside its plain version, one PyTorch call where one
    computes the function, and its bound; K2 at 2x L2 likewise.  Each
    kernel's output at these shapes is held against its plain version's
    (:func:`compare_stream`); returns the largest errors and shares of the
    tolerance beside the rows."""
    import torch

    from repro_torch.configs.a64fx_kernelsuite import KERNELS as SUITE
    from repro_torch.core import calibrate as cal
    from repro_torch.kernels import stream

    c0 = stream.C0
    library = {  # one PyTorch call computing the same function, or None
        "add": lambda a, b, y: torch.add(a, b),
        "sub": lambda a, b, y: torch.sub(a, b),
        "mul": lambda a, b, y: torch.mul(a, b),
        "fma": lambda a, b, y: torch.add(y, a, alpha=c0),
        "div": lambda a, b, y: torch.div(a, b),
        "rev": lambda a, b, y: torch.reciprocal(a),
        "sqrt": lambda a, b, y: torch.sqrt(a),
        "f2d": lambda a, b, y: a.to(torch.float64),
        "i2d": lambda a, b, y: a.to(torch.float64),
        "d2f": lambda a, b, y: a.to(torch.float32),
        "d2i": lambda a, b, y: a.to(torch.int32),
        "aint": lambda a, b, y: torch.trunc(a),
        "nint": None,                 # round, then a cast: two calls
        "anint": lambda a, b, y: torch.round(a),
        "abs": lambda a, b, y: torch.abs(a),
        "max": lambda a, b, y: torch.maximum(a, b),
        "min": lambda a, b, y: torch.minimum(a, b),
        "mod": None, "sign": None,
        "atan": lambda a, b, y: torch.atan(a),
        "atan2": lambda a, b, y: torch.atan2(a, b),
        "cos": lambda a, b, y: torch.cos(a),
        "sin": lambda a, b, y: torch.sin(a),
        "exp": lambda a, b, y: torch.exp(a),
        "exp10": None,
        "log": lambda a, b, y: torch.log(a),
        "log10": lambda a, b, y: torch.log10(a),
        "pwr": None,
    }
    f64_flops = sass_f64_flops(lib_path)
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    print(f"[time] K1 at Table 1's n x {HBM_SCALE} (HBM-resident), us: "
          f"{'kernel':>9s}{'plain':>10s}{'torch':>10s}{'bound':>9s} by"
          f"      bytes/elem  f64 flops/elem (SASS: fewest path, all)"
          f"  max|err| not-bit-identical")
    k1_err = k1_used = 0.0
    for k in SUITE:
        n = k.n * HBM_SCALE
        x1, x2, y0 = cal._kernel_inputs(k, n, gen, dev)
        args = (k.name, x1, x2, y0)
        got = stream.elementwise(*args)
        torch.cuda.synchronize()
        err, used, differ = compare_stream(
            f"K1 {k.name} n={n}", got, stream.elementwise_plain(*args),
            STREAM_TOL, STREAM_TOL, exact=True)
        k1_err, k1_used = max(k1_err, err), max(k1_used, used)
        del got
        k_ms = time_ms(lambda: stream.elementwise(*args), STREAM_ITERS)
        p_ms = time_ms(lambda: stream.elementwise_plain(*args), STREAM_ITERS)
        lib = library[k.name]
        l_ms = (time_ms(lambda: lib(x1, x2, y0), STREAM_ITERS)
                if lib is not None else None)
        nbytes = cal.kernel_program(k.name, n).ops[0].bytes_accessed
        t_bytes = nbytes / HBM_BYTES_PER_S
        fewest, every = f64_flops[k.name]
        t_ops = fewest * n / PEAK_F64_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        by = "operations" if t_ops > t_bytes else "bytes"
        rows.append({"name": k.name, "n": n, "ms": k_ms, "plain_ms": p_ms,
                     "library_ms": l_ms, "bound_ms": bound_ms,
                     "bound_by": by, "bytes": nbytes,
                     "f64_flops_per_element": [fewest, every],
                     "max_abs_err": err, "not_bit_identical": differ})
        lib_txt = f"{l_ms * 1e3:10.1f}" if l_ms is not None else "      none"
        print(f"[time] K1 {k.name:<6s} n={n:>9d}: {k_ms * 1e3:9.1f}"
              f"{p_ms * 1e3:10.1f}{lib_txt}{bound_ms * 1e3:9.1f} {by:<10s}"
              f"{nbytes / n:6.0f}{fewest:8d}{every:6d}  {err:.3e} {differ}")
        del x1, x2, y0
    n = TRIAD_MEM_N
    a = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    b = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    k2_err, k2_used, k2_differ = compare_stream(
        f"K2 float64 n={n}", stream.stream_triad(a, b, 3.0),
        stream.stream_triad_plain(a, b, 3.0), *TRIAD_TOL["float64"])
    k2 = {"ms": time_ms(lambda: stream.stream_triad(a, b, 3.0), STREAM_ITERS),
          "plain_ms": time_ms(lambda: stream.stream_triad_plain(a, b, 3.0),
                              STREAM_ITERS),
          "library_ms": time_ms(lambda: torch.add(a, b, alpha=3.0),
                                STREAM_ITERS)}
    t_bytes, t_ops = 3 * 8 * n / HBM_BYTES_PER_S, 2 * n / PEAK_F64_FLOPS
    k2.update(bound_ms=max(t_bytes, t_ops) * 1e3,
              bound_by="operations" if t_ops > t_bytes else "bytes",
              shape=f"n={n} f64 (2x L2), grid filling the card")
    print(f"[time] K2 n={n} f64: kernel {k2['ms'] * 1e3:.1f} us, plain "
          f"{k2['plain_ms'] * 1e3:.1f} us, torch.add(a, b, alpha=3) "
          f"{k2['library_ms'] * 1e3:.1f} us, bound {k2['bound_ms'] * 1e3:.1f}"
          f" us ({3 * 8 * n / 1e6:.1f} MB over {HBM_BYTES_PER_S / 1e12:g} "
          f"TB/s); kernel at {3 * 8 * n / k2['ms'] / 1e6:.0f} GB/s; vs plain "
          f"max|err| {k2_err:.3e}, {k2_differ} not bit-identical")
    return {"k1": rows, "k2": k2, "k1_err": k1_err, "k1_used": k1_used,
            "k2_err": k2_err, "k2_used": k2_used}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import ARCHS, RunConfig, ShapeConfig
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import params as pr
    from repro_torch.launch.train import build_training, train_loop
    from repro_torch.models.lm import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.trainer import make_eval_step

    # f32 products in full f32, never TF32 (the plain versions' yardstick)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # 1. the card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {kind}; count {count}")

    # 2. the build: one nvcc per source, all started together -------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = list(pool.map(_build.load, SOURCES))
    print(f"[build] {len(builds)} libraries in "
          f"{time.perf_counter() - t0:.2f} s (compiled side by side)")
    for built in builds:
        print(f"[build] {built.name}: nvcc {built.seconds:.2f} s "
              f"({built.path.name})")
        for line in built.log.splitlines():
            if "ptxas info" in line and "Compiling" in line:
                print("[build]  ", line.split("'")[1] if "'" in line else line)
            elif "registers" in line or "spill" in line or "C75" in line:
                print("[build]     ", line.strip())   # C75xx: wgmma serialized
    fa_lib = next(b.lib for b in builds if b.name == "flash_attention")
    print("[build] flash_attention dynamic shared memory a CTA, bf16 / f32 "
          "bytes: " + ", ".join(
              f"D={d} {fa_lib.repro_flash_attention_smem_bytes(1, d)} / "
              f"{fa_lib.repro_flash_attention_smem_bytes(0, d)}"
              for d in fa.KERNEL_HEAD_DIMS)
          + "; the bf16 kernel's ptxas register count is its launch bound "
          "(384 threads), then setmaxnreg gives the consumer warpgroups 240 "
          "and the producer 24")

    # 3. kernel vs plain ---------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def compare(B, sq, sk, h, kvh, d, causal, dtype, bshd=False):
        """K3 against its plain version; ``bshd``: q, k, v are (B, S, H, D)
        tensors transposed to (B, H, S, D) views, as the models pass them."""
        shape_q, shape_kv = (B, h, sq, d), (B, kvh, sk, d)
        if bshd:
            q, k, v = (torch.randn((s[0], s[2], s[1], s[3]), generator=gen,
                                   device=dev).to(dtypes[dtype]).transpose(1, 2)
                       for s in (shape_q, shape_kv, shape_kv))
        else:
            q, k, v = (torch.randn(s, generator=gen, device=dev).to(
                dtypes[dtype]) for s in (shape_q, shape_kv, shape_kv))
        got = fa.flash_attention_bhsd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal).float()
        diff = (got.float() - want).abs()
        tol = KERNEL_TOL[dtype]
        err = diff.max().item()
        used = (diff / (tol + tol * want.abs())).max().item()  # <= 1 passes
        print(f"[check] B={B} Sq={sq} Sk={sk} H={h} KVH={kvh} D={d} "
              f"causal={causal} {dtype}{' (B,S,H,D) views' if bshd else ''}: "
              f"max|err| {err:.3e}, "
              f"{used:.1%} of |err| <= {tol:g} + {tol:g}|plain| "
              f"{'ok' if used <= 1 else 'FAIL'}")
        if used > 1:
            fail(f"flash kernel disagrees with its plain version at "
                 f"{(B, sq, sk, h, kvh, d, causal, dtype)}")
        return err, used

    for shape in UNIT_GRID:
        for causal in (True, False):
            for dtype in ("float32", "bfloat16"):
                compare(*shape, causal, dtype)
    cfg = ARCHS[ARCH]
    main_err, main_used = map(max, zip(*(
        compare(1, s, s, h, kvh, d, True, "bfloat16", bshd=True)
        for _, h, kvh, d, s in FLASH_TIMING)))

    # 3b. K4 vs plain: the reference test's distributions, made on the card
    def ssd_inputs(B, L, H, P, N, dtype, broadcast):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        x = randn(B, L, H, P).to(dtype)
        dt = torch.nn.functional.softplus(randn(B, L, H)).to(dtype)
        A = -torch.exp(0.5 * randn(H))
        heads = 1 if broadcast else H
        Bm, Cm = ((0.5 * randn(B, L, heads, N)).to(dtype).expand(B, L, H, N)
                  for _ in range(2))
        return x, dt, A, Bm, Cm

    def compare_ssd(B, L, H, P, N, chunk, dtype, broadcast):
        Q = min(chunk, L)
        nc = L // Q
        x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, dtypes[dtype], broadcast)
        args = [t[:, :nc * Q].reshape(B, nc, Q, *t.shape[2:])
                for t in (x, dt)] + [A] + [
                t[:, :nc * Q].reshape(B, nc, Q, *t.shape[2:])
                for t in (Bm, Cm)]
        if broadcast and args[3].stride(3) != 0:
            fail("the head-broadcast B was copied")
        got = ssd.ssd_chunk(*args)
        torch.cuda.synchronize()
        want = ssd.ssd_chunk_plain(*args)
        errs, used = [], 0.0
        for g, w, tol in zip(got, want, (SSD_TOL[dtype], SSD_F32_TOL,
                                         SSD_F32_TOL)):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"K4 output {tuple(g.shape)} {g.dtype}, plain "
                     f"{tuple(w.shape)} {w.dtype}")
            diff = (g.float() - w.float()).abs()
            errs.append(diff.max().item())
            used = max(used, (diff / (tol + tol * w.float().abs())).max()
                       .item())
        ok = used <= 1 and all(torch.isfinite(g).all() for g in got)
        print(f"[check] K4 B={B} nc={nc} Q={Q} H={H} P={P} N={N} {dtype} "
              f"{'broadcast' if broadcast else 'contiguous'} B/C: max|err| "
              f"y {errs[0]:.3e}, states {errs[1]:.3e}, gamma {errs[2]:.3e}; "
              f"{used:.1%} of |err| <= tol + tol|plain| (y {SSD_TOL[dtype]:g}"
              f", states/gamma {SSD_F32_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K4 disagrees with its plain version at "
                 f"{(B, L, H, P, N, chunk, dtype, broadcast)}")
        return max(errs), used

    ssd_checks = {}
    for shape in SSD_GRID:
        for dtype in ("float32", "bfloat16"):
            for broadcast in (False, True):
                ssd_checks[shape, dtype, broadcast] = compare_ssd(
                    *shape, dtype, broadcast)
    ssd_err, ssd_used = map(max, zip(*(
        v for (shape, dtype, broadcast), v in ssd_checks.items()
        if shape[1] == 2048 and dtype == "bfloat16" and broadcast)))

    # 3c. ops.ssd_scan through K4: the sequential oracle, and the split
    # sequence with initial_state, in f32 (the reference's own identities)
    x, dt, A, Bm, Cm = ssd_inputs(1, 300, 8, 64, 128, torch.float32, True)
    y, state = kops.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    y_ref, state_ref = kref.ssd_ref(x, dt, A, Bm, Cm)
    y1, s1 = kops.ssd_scan(x[:, :200], dt[:, :200], A, Bm[:, :200],
                           Cm[:, :200], chunk=256)
    y2, s2 = kops.ssd_scan(x[:, 200:], dt[:, 200:], A, Bm[:, 200:],
                           Cm[:, 200:], chunk=256, initial_state=s1)
    for what, got, want in (
            ("ssd_scan vs ssd_ref, y", y, y_ref),
            ("ssd_scan vs ssd_ref, state", state, state_ref),
            ("split at 200 with initial_state, y", torch.cat([y1, y2], 1), y),
            ("split at 200 with initial_state, state", s2, state)):
        diff = (got - want).abs()
        used = (diff / (SSD_SCAN_TOL + SSD_SCAN_TOL * want.abs())).max().item()
        print(f"[check] {what} (L=300 H=8 P=64 N=128 chunk 256 f32): "
              f"max|err| {diff.max().item():.3e}, {used:.1%} of "
              f"{SSD_SCAN_TOL:g} + {SSD_SCAN_TOL:g}|want| "
              f"{'ok' if used <= 1 else 'FAIL'}")
        if used > 1:
            fail(f"{what}: ops.ssd_scan disagrees")

    # 3d. K5 vs plain and both vs f64, on random cotangents
    def bwd_allowed(name, dtype, ref, times=1):
        """The K5 tolerance (above) for output ``name`` against ``ref``."""
        a = ref.abs()
        if name == "dx" and dtype == "bfloat16":
            return times * SSD_BWD_TOL[dtype] * (1 + a)
        group = {"da": (0, 1), "ddt": (2,)}.get(name, (2, 4))  # cell or head
        return times * (SSD_BWD_TOL["float32"] * (1 + a)
                        + SSD_BWD_GROUP_TOL * a.amax(group, keepdim=True))

    def compare_ssd_bwd(B, L, H, P, N, chunk, dtype, broadcast):
        Q = min(chunk, L)
        nc = L // Q
        x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, dtypes[dtype], broadcast)
        args = [t[:, :nc * Q].reshape(B, nc, Q, *t.shape[2:])
                for t in (x, dt)] + [A] + [
                t[:, :nc * Q].reshape(B, nc, Q, *t.shape[2:])
                for t in (Bm, Cm)]
        dy = torch.randn((B, nc, Q, H, P), generator=gen,
                         device=dev).to(dtypes[dtype])
        dstates = torch.randn((B, nc, H, N, P), generator=gen, device=dev)
        dgamma = torch.randn((B, nc, H), generator=gen, device=dev)
        got = ssd.ssd_chunk_bwd(*args, dy, dstates, dgamma)
        torch.cuda.synchronize()
        want = ssd.ssd_chunk_bwd_plain(*args, dy, dstates, dgamma)
        exact = ssd.ssd_chunk_bwd_plain(*(t.double() for t in (
            *args, dy, dstates, dgamma)))
        names = ("dx", "ddt", "dB", "dC", "da")
        errs, used = {}, {"kernel-plain": 0.0, "kernel-f64": 0.0,
                          "plain-f64": 0.0}
        for name, g, w, e in zip(names, got, want, exact):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"K5 {name} {tuple(g.shape)} {g.dtype}, plain "
                     f"{tuple(w.shape)} {w.dtype}")
            g, w = g.double(), w.double()
            errs[name] = (g - w).abs().max().item()
            for pair, a, b, times in (("kernel-plain", g, w, 2),
                                      ("kernel-f64", g, e, 1),
                                      ("plain-f64", w, e, 1)):
                used[pair] = max(used[pair], ((a - b).abs() / bwd_allowed(
                    name, dtype, b, times)).max().item())
        ok = max(used.values()) <= 1 and all(torch.isfinite(g).all()
                                             for g in got)
        print(f"[check] K5 B={B} nc={nc} Q={Q} H={H} P={P} N={N} {dtype} "
              f"{'broadcast' if broadcast else 'contiguous'} B/C: max|err| "
              "against plain " + ", ".join(f"{k} {v:.3e}" for k, v in
                                           errs.items())
              + "; share of the tolerance " + ", ".join(
                  f"{k} {v:.1%}" for k, v in used.items())
              + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K5, its plain version and f64 disagree at "
                 f"{(B, L, H, P, N, chunk, dtype, broadcast)}")
        return max(errs.values()), max(used.values())

    bwd_checks = {}
    for shape in SSD_BWD_GRID:
        for dtype in ("float32", "bfloat16"):
            for broadcast in (False, True):
                bwd_checks[shape, dtype, broadcast] = compare_ssd_bwd(
                    *shape, dtype, broadcast)
                gc.collect()
                torch.cuda.empty_cache()
    bwd_err, bwd_used = bwd_checks[SSD_BWD_GRID[-2], "bfloat16", True]

    # 3e. gradients of ops.ssd_scan (K4 + K5) against autograd through the
    # sequential oracle, on random cotangents, with and without initial_state
    def grads_of(fn, x, dt, A, Bm, Cm, s0, cot_y, cot_s):
        H = x.shape[2]
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, dt, A, Bm[:, :, :1], Cm[:, :, :1])]
        init = None if s0 is None else s0.clone().requires_grad_(True)
        bh, ch = (t.expand(-1, -1, H, -1) for t in leaves[3:])
        y, s = fn(*leaves[:3], bh, ch, initial_state=init)
        ((y * cot_y).sum() + (s * cot_s).sum()).backward()
        return [t.grad for t in leaves] + ([] if init is None else [init.grad])

    for B, L, H, P, N, chunk in SSD_GRID[:2] + [(1, 300, 8, 64, 128, 256)]:
        x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, torch.float32, True)
        cot_y = torch.randn((B, L, H, P), generator=gen, device=dev)
        cot_s = torch.randn((B, H, P, N), generator=gen, device=dev)
        for s0 in (None, torch.randn((B, H, P, N), generator=gen, device=dev)):
            got = grads_of(lambda *a, **k: kops.ssd_scan(*a, chunk=chunk, **k),
                           x, dt, A, Bm, Cm, s0, cot_y, cot_s)
            want = grads_of(kref.ssd_ref, x, dt, A, Bm, Cm, s0, cot_y, cot_s)
            used = max(((g - w).abs() / (SSD_SCAN_TOL + SSD_SCAN_TOL * w.abs()))
                       .max().item() for g, w in zip(got, want))
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            print(f"[check] grad of ssd_scan vs ssd_ref (B={B} L={L} H={H} "
                  f"P={P} N={N} chunk {chunk} f32, initial_state "
                  f"{s0 is not None}; x, dt, A, B, C"
                  f"{', state' if s0 is not None else ''}): max|err| "
                  f"{err:.3e}, {used:.1%} of {SSD_SCAN_TOL:g} + "
                  f"{SSD_SCAN_TOL:g}|want| {'ok' if used <= 1 else 'FAIL'}")
            if used > 1:
                fail("the gradient of ops.ssd_scan disagrees with ssd_ref's")

    # 3f. K1 (28 expressions) and K2 (CTA caps) vs plain ------------------
    stream_checks = check_stream(dev)

    def reset_launches():
        fa.flash_attention_bhsd.launches = ssd.ssd_chunk.launches = 0
        ssd.ssd_chunk_bwd.launches = 0

    def read_launches():
        return {"flash_attention": fa.flash_attention_bhsd.launches,
                "ssd_scan": ssd.ssd_chunk.launches,
                "ssd_scan_bwd": ssd.ssd_chunk_bwd.launches}

    # serving helpers, shared by the three models ----------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def serve_full(arch, prompt_lens, new_tokens, want):
        """Seeded bf16 weights, one request at a time through
        ServeEngine.generate; checks each kernel's launch count against
        ``want`` and every token's range.  Returns (serving record, model,
        params, engine, prompts)."""
        cfg = ARCHS[arch]
        model = build_model(cfg, attn_impl="flash", ssd_impl="kernel")
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in pr.leaves(params))
        print(f"[serve] {arch}: {n_params / 1e9:.3f} B parameters in bf16 "
              f"({n_params * 2 / 1e9:.2f} GB), drawn in "
              f"{time.perf_counter() - t0:.1f} s")
        if n_params != cfg.param_count():
            fail(f"{n_params} parameters, config says {cfg.param_count()}")
        rng = np.random.default_rng(0)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
                   for n in prompt_lens]
        engine = ServeEngine(model, params,
                             max_seq=max(prompt_lens) + new_tokens, device=dev)
        engine.generate([prompts[0][:16]], max_new_tokens=2)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        timings, peaks, outs = [], [], []
        t_all = time.perf_counter()
        for prompt in prompts:          # one call each: peak memory per request
            torch.cuda.reset_peak_memory_stats()
            outs += engine.generate([prompt], max_new_tokens=new_tokens)
            peaks.append(torch.cuda.max_memory_allocated())
            timings += engine.timings
        wall = time.perf_counter() - t_all
        got = read_launches()
        print(f"[serve] {arch} launches: {got} (want {want})")
        if got != want:
            fail(f"{arch}: kernel launches {got}, want {want}")
        for n, out in zip(prompt_lens, outs):
            if len(out) != new_tokens or not all(0 <= t < cfg.padded_vocab
                                                 for t in out):
                fail(f"{arch}: request of {n} tokens returned {out}")
        for t, peak in zip(timings, peaks):
            req_s = t.prefill_s + t.decode_s
            print(f"[serve] {arch} prompt {t.prompt_len:5d}: prefill "
                  f"{t.prefill_s * 1e3:9.2f} ms, decode "
                  f"{t.decode_s * 1e3 / t.decode_steps:7.2f} ms/token over "
                  f"{t.decode_steps} tokens, {(t.decode_steps + 1) / req_s:.2f}"
                  f" tokens/s, peak memory {peak / 2**30:.3f} GiB")
        new = sum(len(o) for o in outs)
        record = {
            "arch": arch, "params": n_params, "dtype": "bfloat16",
            "requests": len(prompts), "prompt_tokens": list(prompt_lens),
            "new_tokens_per_request": new_tokens, "wall_s": wall,
            "tokens_per_s": new / wall,
            "prefill_ms": [t.prefill_s * 1e3 for t in timings],
            "decode_ms_per_token": [t.decode_s * 1e3 / t.decode_steps
                                    for t in timings],
            "peak_mem_bytes": peaks, "launches": got}
        print(f"[serve] {arch}: {new} new tokens in {wall:.3f} s "
              f"({record['tokens_per_s']:.2f} tokens/s)")
        return record, model, params, engine, prompts

    def kernel_seconds(fn):
        """Device seconds of every kernel that ``fn`` runs, those of each
        kernel of the port (by the name of its CUDA function), and the
        number of kernels."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e6
        named = {k: sum(e.self_device_time_total for e in kern
                        if fn_name in e.name) / 1e6
                 for k, fn_name in KERNEL_FUNCTIONS.items()}
        named["cublas"] = sum(
            e.self_device_time_total for e in kern
            if any(s in e.name.lower() for s in CUBLAS_FUNCTIONS)) / 1e6
        return busy, named, len(kern)

    def host_seconds(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def trace_serving(arch, model, params, engine, prompt, steps=8):
        """Where the device time goes: one prefill of ``prompt`` and
        ``steps`` decode steps after it, each on the host clock unprofiled,
        then under the profiler (kernel time, each port kernel's share, the
        number of kernels, the device's idle share)."""
        with torch.inference_mode():
            toks = torch.tensor([prompt], device=dev)
            _, cache = engine._prefill_one(prompt)
            tok = torch.zeros((1, 1), dtype=torch.long, device=dev)

            def prefill():
                model.prefill_fn(params, {"tokens": toks})

            def decode():
                for i in range(steps):
                    model.decode_fn(params, cache, {"tokens": tok,
                                                    "pos": len(prompt) + i})

            pre_wall, dec_wall = host_seconds(prefill), host_seconds(decode)
            pre_busy, pre_named, pre_n = kernel_seconds(prefill)
            dec_busy, _, dec_n = kernel_seconds(decode)
        if not (pre_busy > 0 and dec_busy > 0):
            print(f"[trace] {arch}: the profiler reported no device time: "
                  f"not measured")
            return "not measured"
        n = len(prompt)
        trace = {
            "prefill_tokens": n, "prefill_kernels": pre_n,
            "prefill_kernel_ms": pre_busy * 1e3,
            **{f"prefill_{k}_ms": v * 1e3 for k, v in pre_named.items()},
            "prefill_host_ms": pre_wall * 1e3,
            "prefill_device_idle_share": 1 - pre_busy / pre_wall,
            "decode_kernels_per_token": dec_n / steps,
            "decode_kernel_ms_per_token": dec_busy * 1e3 / steps,
            "decode_host_ms_per_token": dec_wall * 1e3 / steps,
            "decode_device_idle_share": 1 - dec_busy / dec_wall}
        shares = ", ".join(f"{k} {v * 1e3:.2f} ms ({v / pre_busy:.1%})"
                           for k, v in pre_named.items() if v)
        print(f"[trace] {arch} prefill {n}: {pre_n} kernels, "
              f"{pre_busy * 1e3:.2f} ms of kernel time ({shares}) of "
              f"{pre_wall * 1e3:.2f} ms on the host clock (device idle "
              f"{trace['prefill_device_idle_share']:.1%}); decode: "
              f"{dec_n / steps:.0f} kernels and {dec_busy * 1e3 / steps:.2f} "
              f"ms/token of kernel time of {dec_wall * 1e3 / steps:.2f} "
              f"ms/token on the host clock (device idle "
              f"{trace['decode_device_idle_share']:.1%})")
        return trace

    # 4. full-width serving of chatglm3-6b, K3 in every layer ---------------
    serving, model, params, engine, prompts = serve_full(
        ARCH, PROMPT_LENS, NEW_TOKENS,
        {"flash_attention": cfg.n_layers * len(PROMPT_LENS), "ssd_scan": 0,
         "ssd_scan_bwd": 0})
    serving["trace"] = trace_serving(ARCH, model, params, engine, prompts[-1])

    # 5. model-level cross-check: flash (kernel) vs blocked (plain PyTorch)
    toks = torch.tensor([prompts[2]], device=dev)
    with torch.inference_mode():
        lf, _ = model.prefill_fn(params, {"tokens": toks})
        lb, _ = build_model(cfg, attn_impl="blocked").prefill_fn(
            params, {"tokens": toks})
    lf, lb = lf.float(), lb.float()
    if not (torch.isfinite(lf).all() and torch.isfinite(lb).all()):
        fail("non-finite logits")
    rel = ((lf - lb).abs().max() / lb.abs().max()).item()
    same_top = bool(torch.equal(lf.argmax(-1), lb.argmax(-1)))
    print(f"[xcheck] {len(prompts[2])}-token prefill, flash vs blocked: "
          f"max|dlogit|/max|logit| {rel:.3e} (tol {XCHECK_TOL:g}); same "
          f"argmax {same_top}")
    serving["xcheck_rel_err"] = rel
    if rel > XCHECK_TOL:
        fail(f"flash and blocked prefill logits differ by {rel:.3e}")

    # 6. timing: K3, SDPA and the plain version on device time --------------
    # Each call is queued behind a ~100 us device-side spin
    # (core/calibrate.py's _median_time), so the events around it time the
    # card, not the wrapper's per-call host cost (checks, allocation, ctypes,
    # three tensor-map encodes), which exceeds K3's time at S = 512.
    from repro_torch.core import calibrate as cal
    sdpa = torch.nn.functional.scaled_dot_product_attention
    print(f"[time] flash: the median of {FLASH_REPEATS} calls (plain: 3), "
          f"each queued behind a device-side spin of {cal.SPIN_CYCLES} "
          f"cycles, CUDA events around the call alone; q, k, v (B,S,H,D) "
          f"views as the models pass them")
    flash_rows = []
    for label, H, KVH, D, S in FLASH_TIMING:
        q, k, v = (torch.randn((1, S, n, D), generator=gen, device=dev)
                   .bfloat16().transpose(1, 2) for n in (H, KVH, KVH))
        kernel_ms = cal._median_time(
            lambda q: fa.flash_attention_bhsd(q, k, v, causal=True), (q,),
            FLASH_REPEATS) * 1e3
        plain_ms = cal._median_time(
            lambda q: fa.flash_attention_plain(q, k, v, causal=True), (q,),
            3) * 1e3
        library_ms = cal._median_time(
            lambda q: sdpa(q, k, v, is_causal=True, enable_gqa=True), (q,),
            FLASH_REPEATS) * 1e3
        flops = 4 * H * D * (S * (S + 1) // 2)   # q.k and p.v, causal pairs
        nbytes = 2 * (2 * H * S * D + 2 * KVH * S * D)   # q, o; k, v
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        row = {"shape": f"{label} B=1 H={H} KVH={KVH} S={S} D={D} bf16 "
                        f"causal", "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": flops / 1e9, "mb": nbytes / 1e6}
        flash_rows.append(row)
        print(f"[time] flash {row['shape']}: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB); kernel at "
              f"{flops / kernel_ms / 1e9:.1f} TFLOP/s, "
              f"{bound_ms / kernel_ms:.1%} of the bound, "
              f"{kernel_ms / library_ms:.3f}x sdpa's time")
        del q, k, v
    flash_timing = {**{key: flash_rows[0][key] for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape")},
        "timing": "device time: each call behind a device-side spin",
        "by_shape": flash_rows}
    servings = [serving]
    del model, params, engine
    gc.collect()
    torch.cuda.empty_cache()

    # 7./8./9. full-width serving of the SSM and hybrid models --------------
    def xcheck(arch, model, params, prompt):
        """Last-position logits through K4 against the plain chunked scan.

        The yardstick is the chunked scan with the same weights in f32.
        With f32 weights the kernel path differs from it in summation order
        only (limit XCHECK_F32_TOL).  In bf16 both paths round weights and
        activations, so over 48 layers the chunked path itself lands a few
        1e-2 away; the kernel path may be at most XCHECK_TOL further away
        than the chunked path in bf16 is.  The kernel path's argmax must be
        the yardstick's, in f32 and in bf16."""
        toks = torch.tensor([prompt], device=dev)
        p32 = pr.tree_map(lambda t: t.float(), params)
        logits = {}
        with torch.inference_mode():
            for impl in ("kernel", "chunked"):
                m = build_model(model.cfg, attn_impl="flash", ssd_impl=impl)
                for dtype, p in (("bfloat16", params), ("float32", p32)):
                    lg, _ = m.prefill_fn(p, {"tokens": toks})
                    logits[impl, dtype] = lg.float()
        del p32
        if not all(torch.isfinite(lg).all() for lg in logits.values()):
            fail(f"{arch}: non-finite logits")
        truth = logits["chunked", "float32"]

        def rel(a, b):
            return ((a - b).abs().max() / b.abs().max()).item()

        out = {"kernel_f32_vs_f32": rel(logits["kernel", "float32"], truth),
               "kernel_bf16_vs_f32": rel(logits["kernel", "bfloat16"], truth),
               "chunked_bf16_vs_f32": rel(logits["chunked", "bfloat16"], truth),
               "kernel_bf16_vs_chunked_bf16": rel(logits["kernel", "bfloat16"],
                                                  logits["chunked", "bfloat16"])}
        for dtype, tag in (("float32", "f32"), ("bfloat16", "bf16")):
            out[f"same_argmax_{tag}"] = bool(torch.equal(
                logits["kernel", dtype].argmax(-1), truth.argmax(-1)))
        bf16_limit = out["chunked_bf16_vs_f32"] + XCHECK_TOL
        print(f"[xcheck] {arch} {len(prompt)}-token prefill, max|dlogit|/"
              f"max|logit| against the chunked scan in f32: kernel in f32 "
              f"{out['kernel_f32_vs_f32']:.3e} (tol {XCHECK_F32_TOL:g}); "
              f"kernel in bf16 {out['kernel_bf16_vs_f32']:.3e} (tol "
              f"{bf16_limit:.3e}), chunked in bf16 "
              f"{out['chunked_bf16_vs_f32']:.3e}; kernel vs chunked, both "
              f"bf16: {out['kernel_bf16_vs_chunked_bf16']:.3e}; same argmax "
              f"in f32 {out['same_argmax_f32']}, in bf16 "
              f"{out['same_argmax_bf16']}")
        if out["kernel_f32_vs_f32"] > XCHECK_F32_TOL \
                or out["kernel_bf16_vs_f32"] > bf16_limit \
                or not (out["same_argmax_f32"] and out["same_argmax_bf16"]):
            failures.append(f"{arch}: kernel-path logits off the f32 chunked "
                            f"scan: {out}")  # reported after the timing
        return out

    failures = []
    # 7. mamba2-1.3b: 48 layers, K4 in every one, 4 requests
    ssm_cfg = ARCHS[SSM_ARCH]
    serving, model, params, engine, prompts = serve_full(
        SSM_ARCH, SSM_PROMPT_LENS, NEW_TOKENS,
        {"flash_attention": 0,
         "ssd_scan": ssm_cfg.n_layers * len(SSM_PROMPT_LENS),
         "ssd_scan_bwd": 0})
    serving["trace"] = trace_serving(SSM_ARCH, model, params, engine,
                                     prompts[-1])
    # 9a. mamba2-1.3b: kernel vs chunked logits at the 1000-token prompt
    serving["xcheck"] = xcheck(SSM_ARCH, model, params, prompts[2])
    servings.append(serving)
    del model, params, engine

    # 8. zamba2-1.2b: 38 Mamba2 layers (K4) and 7 shared attention blocks (K3)
    hyb_cfg = ARCHS[HYBRID_ARCH]
    n_inv = len(range(0, hyb_cfg.n_layers, hyb_cfg.shared_attn_every))
    serving, model, params, engine, prompts = serve_full(
        HYBRID_ARCH, HYBRID_PROMPT_LENS, HYBRID_NEW_TOKENS,
        {"flash_attention": n_inv * len(HYBRID_PROMPT_LENS),
         "ssd_scan": hyb_cfg.n_layers * len(HYBRID_PROMPT_LENS),
         "ssd_scan_bwd": 0})
    serving["trace"] = trace_serving(HYBRID_ARCH, model, params, engine,
                                     prompts[-1])
    # 9b. zamba2-1.2b: kernel vs chunked logits at a 1000-token prompt
    rng = np.random.default_rng(1)
    serving["xcheck"] = xcheck(
        HYBRID_ARCH, model, params,
        [int(t) for t in rng.integers(0, hyb_cfg.vocab_size, size=1000)])
    servings.append(serving)
    del model, params, engine
    gc.collect()
    torch.cuda.empty_cache()

    # 10. K4 timing at mamba2-1.3b's 2048-token prefill shape ---------------
    sc = ssm_cfg.ssm
    B, L = 1, 2048
    H, P, N, Q = sc.n_heads(ssm_cfg.d_model), sc.head_dim, sc.d_state, sc.chunk
    nc = L // Q
    x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, torch.bfloat16, True)
    args = [t.reshape(B, nc, Q, *t.shape[2:]) for t in (x, dt)] + [A] + [
        t.reshape(B, nc, Q, *t.shape[2:]) for t in (Bm, Cm)]
    k4_shape = f"B={B} nc={nc} Q={Q} H={H} P={P} N={N} bf16, B/C broadcast"
    k4_ms = time_ms(lambda: ssd.ssd_chunk(*args), 50)
    k4_plain_ms = time_ms(lambda: ssd.ssd_chunk_plain(*args), 5, warmup=1)
    cells = B * nc * H
    pairs = Q * (Q + 1) // 2                      # causal (i, j) pairs
    # C_i.B_j does not depend on the head: once per (batch, chunk, group),
    # bf16 x bf16 products, exact on the tensor cores; M.X and the state
    # B^T diag(w) X per head take f32 operands (M, w) at the f32 rate
    k4_flops_cb = B * nc * sc.n_groups * 2 * pairs * N
    k4_flops_f32 = cells * (2 * pairs * P + 2 * Q * N * P)
    k4_flops = k4_flops_cb + k4_flops_f32
    k4_bytes = (2 * 2 * B * L * H * P             # x read, y_diag written
                + 2 * B * L * H                   # dt
                + 2 * 2 * B * L * N               # B, C: one group
                + 4 * H                           # A
                + 4 * cells * N * P + 4 * cells)  # states, gamma (f32)
    k4_ops_s = max(k4_flops_cb / PEAK_BF16_FLOPS, k4_flops_f32 / PEAK_F32_FLOPS)
    k4_bytes_s = k4_bytes / HBM_BYTES_PER_S
    k4_bound_ms = max(k4_ops_s, k4_bytes_s) * 1e3
    print(f"[time] K4 B={B} nc={nc} Q={Q} H={H} P={P} N={N} bf16, B/C "
          f"broadcast: kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, "
          f"bound {k4_bound_ms:.4f} ms (C.B^T {k4_flops_cb / 1e9:.3f} GFLOP "
          f"over {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s bf16, M.X and states "
          f"{k4_flops_f32 / 1e9:.3f} GFLOP over {PEAK_F32_FLOPS / 1e12:g} "
          f"TFLOP/s f32; {k4_bytes / 1e6:.2f} MB over "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s); kernel at "
          f"{k4_flops / k4_ms / 1e9:.1f} TFLOP/s of needed work, "
          f"{k4_bound_ms / k4_ms:.1%} of the bound; no single PyTorch call "
          f"computes this function")

    del x, dt, A, Bm, Cm, args
    gc.collect()
    torch.cuda.empty_cache()

    # 11./12. full-width training through train_loop -------------------------
    def train_full(arch, batch, steps, want_per_step):
        """RunConfig defaults (bf16, f32 AdamW, remat full), ssd "kernel",
        attention "blocked"; seeded weights and synthetic batches, as
        ``launch.train.train_loop`` makes them."""
        cfg = ARCHS[arch]
        run = RunConfig(model=cfg, shape=ShapeConfig("smoke", TRAIN_SEQ, batch,
                                                     "train"))
        model = build_model(cfg, ssd_impl="kernel")
        evaluate = make_eval_step(model, run)
        batch0 = {"tokens": torch.from_numpy(SyntheticLMDataset(
            cfg.vocab_size, TRAIN_SEQ, batch, seed=0).batch(0)["tokens"]).to(
                dev, torch.long)}
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype=getattr(torch, run.param_dtype))
        loss_before = float(evaluate(params, batch0)["loss"])
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        report = train_loop(model, run, n_steps=steps, seed=0, log_every=1,
                            device=dev)
        wall = time.perf_counter() - t0
        got = read_launches()
        peak = torch.cuda.max_memory_allocated()
        want = {k: v * steps for k, v in want_per_step.items()}
        print(f"[train] {arch} launches: {got} (want {want})")
        if got != want:
            fail(f"{arch} training: kernel launches {got}, want {want}")
        if not all(np.isfinite(report.losses)) or len(report.losses) != steps:
            fail(f"{arch} training losses {report.losses}")
        params, opt_state = report.state
        loss_after = float(evaluate(params, batch0)["loss"])
        tokens = batch * TRAIN_SEQ
        steady = float(np.median(report.step_times[1:]))
        print(f"[train] {arch}: {steps} steps of {batch} x {TRAIN_SEQ} tokens "
              f"in {wall:.2f} s; step ms "
              + ", ".join(f"{t * 1e3:.1f}" for t in report.step_times)
              + f" (median after the first {steady * 1e3:.1f} ms, "
              f"{tokens / steady:.0f} tokens/s); losses "
              + ", ".join(f"{v:.4f}" for v in report.losses)
              + f"; peak memory {peak / 2**30:.2f} GiB; batch 0's loss "
              f"{loss_before:.4f} before, {loss_after:.4f} after")
        if not loss_after < loss_before:
            fail(f"{arch}: batch 0's loss did not fall ({loss_before} -> "
                 f"{loss_after})")
        # where the time goes: one more step under the profiler
        step_fn, _ = build_training(model, run, dev)

        def one_step():
            out = step_fn(params, opt_state, batch0)
            float(out[2]["loss"])

        step_wall = host_seconds(one_step)
        busy, named, n_kern = kernel_seconds(one_step)
        trace = "not measured"
        if busy > 0:
            trace = {"kernels": n_kern, "kernel_ms": busy * 1e3,
                     "host_ms": step_wall * 1e3,
                     "device_idle_share": 1 - busy / step_wall,
                     **{f"{k}_ms": v * 1e3 for k, v in named.items()}}
            shares = ", ".join(f"{k} {v * 1e3:.1f} ms ({v / busy:.1%})"
                               for k, v in named.items())
            print(f"[trace] {arch} training step: {n_kern} kernels, "
                  f"{busy * 1e3:.1f} ms of kernel time ({shares}) of "
                  f"{step_wall * 1e3:.1f} ms on the host clock (device idle "
                  f"{trace['device_idle_share']:.1%})")
        else:
            print(f"[trace] {arch}: the profiler reported no device time: "
                  f"not measured")
        return {"arch": f"{arch} training", "params": n_params_of(params),
                "dtype": run.param_dtype, "batch": batch, "seq": TRAIN_SEQ,
                "steps": steps, "step_ms": [t * 1e3 for t in report.step_times],
                "tokens_per_s": tokens / steady, "losses": report.losses,
                "batch0_loss_before": loss_before,
                "batch0_loss_after": loss_after, "peak_mem_bytes": peak,
                "launches": got, "trace": trace}

    def n_params_of(params):
        return sum(t.numel() for t in pr.leaves(params))

    trainings = [train_full(
        SSM_ARCH, SSM_TRAIN_BATCH, SSM_TRAIN_STEPS,
        {"flash_attention": 0, "ssd_scan": 2 * ssm_cfg.n_layers,
         "ssd_scan_bwd": ssm_cfg.n_layers})]
    gc.collect()
    torch.cuda.empty_cache()
    trainings.append(train_full(
        HYBRID_ARCH, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_STEPS,
        {"flash_attention": 0, "ssd_scan": 2 * hyb_cfg.n_layers,
         "ssd_scan_bwd": hyb_cfg.n_layers}))
    gc.collect()
    torch.cuda.empty_cache()

    # 13. f32 gradients at full width: K4 + K5 against the chunked scan -------
    params = build_model(ssm_cfg).init(
        torch.Generator(device=dev).manual_seed(0), dtype=torch.float32)
    toks = {"tokens": torch.from_numpy(SyntheticLMDataset(
        ssm_cfg.vocab_size, XGRAD_TOKENS, 1, seed=1).batch(0)["tokens"]).to(
            dev, torch.long)}
    leaves = [t.requires_grad_(True) for t in pr.leaves(params)]
    losses, grads = {}, {}
    for impl in ("kernel", "chunked"):
        loss, _ = build_model(ssm_cfg, ssd_impl=impl).loss_fn(params, toks)
        grads[impl] = torch.autograd.grad(loss, leaves)
        losses[impl] = loss.item()
    del leaves, params
    loss_rel = abs(losses["kernel"] - losses["chunked"]) / abs(losses["chunked"])
    grad_rel = max(((gk - gc_).abs().max() / gc_.abs().max()).item()
                   for gk, gc_ in zip(grads["kernel"], grads["chunked"]))
    finite = all(torch.isfinite(g).all() for g in grads["kernel"])
    del grads
    print(f"[xcheck] {SSM_ARCH} f32 gradients, one {XGRAD_TOKENS}-token "
          f"sequence, K4 + K5 against the chunked scan: losses "
          f"{losses['kernel']:.7f} and {losses['chunked']:.7f} ({loss_rel:.2e} "
          f"relative, tol {XGRAD_LOSS_TOL:g}); largest gradient error "
          f"{grad_rel:.2e} of its leaf's largest |g| (tol {XGRAD_TOL:g})")
    if not finite or loss_rel > XGRAD_LOSS_TOL or grad_rel > XGRAD_TOL:
        fail("the K4 + K5 gradients disagree with the chunked scan's")
    gc.collect()
    torch.cuda.empty_cache()

    # 14. K5 timing at mamba2-1.3b's training shape ---------------------------
    B, L = SSM_TRAIN_BATCH, TRAIN_SEQ
    nc = L // Q
    x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, torch.bfloat16, True)
    args = [t.reshape(B, nc, Q, *t.shape[2:]) for t in (x, dt)] + [A] + [
        t.reshape(B, nc, Q, *t.shape[2:]) for t in (Bm, Cm)]
    dy = torch.randn((B, nc, Q, H, P), generator=gen, device=dev).bfloat16()
    dstates = torch.randn((B, nc, H, N, P), generator=gen, device=dev)
    dgamma = torch.randn((B, nc, H), generator=gen, device=dev)
    k5_ms = time_ms(lambda: ssd.ssd_chunk_bwd(*args, dy, dstates, dgamma), 10)
    k5_plain_ms = time_ms(
        lambda: ssd.ssd_chunk_bwd_plain(*args, dy, dstates, dgamma), 5,
        warmup=1)
    cells = B * nc * H
    # bf16 x bf16 products, exact on the tensor cores: C B^T once per group
    # and dM = dy x^T per head (dy is rounded to x's dtype); f32 operands
    # per head, over causal pairs: M^T dy, V B, V^T C; and B dS, (w x) dS^T
    k5_flops_cb = B * nc * sc.n_groups * 2 * pairs * N + cells * 2 * pairs * P
    k5_flops_f32 = cells * (2 * pairs * (P + 2 * N) + 2 * 2 * Q * N * P)
    k5_bytes = (3 * 2 * B * L * H * P             # x, dy read, dx written
                + 2 * B * L * H + 4 * B * L * H   # dt read, ddt written
                + 2 * 2 * B * L * N               # B, C: one group
                + 4 * H                           # A
                + 4 * cells * N * P + 4 * cells   # dS, dgamma
                + 2 * 4 * B * L * H * N           # dB, dC per head, f32
                + 4 * cells)                      # da
    k5_ops_s = max(k5_flops_cb / PEAK_BF16_FLOPS, k5_flops_f32 / PEAK_F32_FLOPS)
    k5_bytes_s = k5_bytes / HBM_BYTES_PER_S
    k5_bound_ms = max(k5_ops_s, k5_bytes_s) * 1e3
    print(f"[time] K5 B={B} nc={nc} Q={Q} H={H} P={P} N={N} bf16, B/C "
          f"broadcast: kernel {k5_ms:.4f} ms, plain {k5_plain_ms:.4f} ms, "
          f"bound {k5_bound_ms:.4f} ms (C.B^T and dM {k5_flops_cb / 1e9:.3f} "
          f"GFLOP "
          f"over {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s bf16, the rest "
          f"{k5_flops_f32 / 1e9:.3f} GFLOP over {PEAK_F32_FLOPS / 1e12:g} "
          f"TFLOP/s f32; {k5_bytes / 1e6:.2f} MB over "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s); kernel at "
          f"{(k5_flops_f32 + k5_flops_cb) / k5_ms / 1e9:.1f} TFLOP/s of "
          f"needed work, {k5_bound_ms / k5_ms:.1%} of the bound; no single "
          f"PyTorch call computes this function")

    # 15.-17. the calibration loop: fit, Fig. 3 tables, O3 sweep, Triad ----
    del x, dt, A, Bm, Cm, args, dy, dstates, dgamma
    gc.collect()
    torch.cuda.empty_cache()
    calibration = calibrate_h100(dev)
    # 18. K1 and K2 timing beside their bounds, plain versions, torch calls
    stream_times = time_stream(dev, next(b.path for b in builds
                                         if b.name == "stream"))

    if failures:
        fail("; ".join(failures))
    for record in servings:
        print(json.dumps({"serving": record}))
    for record in trainings:
        print(json.dumps({"training": record}))
    print(json.dumps({"calibration": calibration}))
    by_path = {k: {r["arch"]: r["launches"][k] for r in servings + trainings}
               for k in KERNELS}
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": sum(by_path["flash_attention"].values()),
        "launches_by_path": by_path["flash_attention"], "max_abs_err": main_err,
        "tolerance": f"|err| <= {KERNEL_TOL['bfloat16']} "
                     f"+ {KERNEL_TOL['bfloat16']}|plain|",
        "share_of_tolerance": main_used, **flash_timing}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:27",
        "launches": sum(by_path["ssd_scan"].values()),
        "launches_by_path": by_path["ssd_scan"], "max_abs_err": ssd_err,
        "tolerance": f"y_diag |err| <= {SSD_TOL['bfloat16']} + "
                     f"{SSD_TOL['bfloat16']}|plain|; states, gamma "
                     f"{SSD_F32_TOL} + {SSD_F32_TOL}|plain|",
        "share_of_tolerance": ssd_used,
        "ms": k4_ms, "kernel_ms": k4_ms, "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound_ms,
        "bound_by": "operations" if k4_ops_s >= k4_bytes_s else "bytes",
        "library_ms": None,
        "shape": k4_shape}, {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:58",
        "launches": sum(by_path["ssd_scan_bwd"].values()),
        "launches_by_path": by_path["ssd_scan_bwd"], "max_abs_err": bwd_err,
        "tolerance": f"dx (bf16) |err| <= {SSD_BWD_TOL['bfloat16']} + "
                     f"{SSD_BWD_TOL['bfloat16']}|plain|; f32 outputs "
                     f"{SSD_BWD_TOL['float32']} + {SSD_BWD_TOL['float32']}"
                     f"|f64| + {SSD_BWD_GROUP_TOL} max|f64| over the "
                     f"(b, c, h) cell (da: over the head), for the kernel "
                     f"and the plain version against f64; twice that "
                     f"between them",
        "share_of_tolerance": bwd_used,
        "ms": k5_ms, "kernel_ms": k5_ms, "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound_ms,
        "bound_by": "operations" if k5_ops_s >= k5_bytes_s else "bytes",
        "library_ms": None,
        "shape": f"B={B} nc={nc} Q={Q} H={H} P={P} N={N} bf16, B/C "
                 f"broadcast"}, {
        "name": "stream_elementwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stream.cu",
        "replaces": "src/repro/kernels/stream.py:74",
        "launches": calibration["launches"]["stream_elementwise"],
        "launches_by_path": {"calibration": calibration["launches"][
            "stream_elementwise"]},
        "max_abs_err": max(stream_checks["k1_err"], stream_times["k1_err"]),
        "tolerance": f"|err| <= {STREAM_TOL} + {STREAM_TOL}|plain| (poly16 "
                     f"in f32: {POLY16_F32_TOL} + {POLY16_F32_TOL}|plain|; "
                     f"fill: exact)",
        "share_of_tolerance": max(stream_checks["k1_used"],
                                  stream_times["k1_used"]),
        "ms": sum(r["ms"] for r in stream_times["k1"]),
        "plain_ms": sum(r["plain_ms"] for r in stream_times["k1"]),
        "bound_ms": sum(r["bound_ms"] for r in stream_times["k1"]),
        "bound_by": ("operations" if sum(
            r["bound_ms"] for r in stream_times["k1"]
            if r["bound_by"] == "operations") > 0.5 * sum(
            r["bound_ms"] for r in stream_times["k1"]) else "bytes"),
        "library_ms": None,
        "shape": f"the 28 Table-1 expressions, one launch each (times "
                 f"summed), n = Table 1's n x {HBM_SCALE}; no one PyTorch "
                 f"call computes the suite, see by_expression",
        "by_expression": stream_times["k1"]}, {
        "name": "stream_triad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stream.cu",
        "replaces": "src/repro/kernels/stream.py:104",
        "launches": calibration["launches"]["stream_triad"],
        "launches_by_path": {"calibration": calibration["launches"][
            "stream_triad"]},
        "max_abs_err": max(stream_checks["k2_err"], stream_times["k2_err"]),
        "tolerance": "f32 |err| <= 1e-6 + 1e-5|plain|, f64 1e-12 + "
                     "1e-12|plain|",
        "share_of_tolerance": max(stream_checks["k2_used"],
                                  stream_times["k2_used"]),
        **stream_times["k2"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
