#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card and
check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card: ``nvidia-smi`` name and power limit, torch's device name, count;
2. the build: ``nvcc`` builds every kernel of the paths from ``src/`` (K3,
   K4 and K5), one compiler per source, all started together (seconds,
   ptxas register, shared-memory and spill lines);
3. kernel vs plain: each kernel against its plain PyTorch version on the card:
   flash attention (K3) at the unit-test grid and chatglm3-6b prefill shapes;
   the SSD chunk kernel (K4) at the reference's grid, a Q < chunk case and the
   mamba2-1.3b and zamba2-1.2b prefill shapes, f32 and bf16, B/C contiguous
   and head-broadcast, then ``ops.ssd_scan`` with ``initial_state`` against
   the split-sequence identity; the SSD backward kernel (K5) against its
   plain version and both against the same math in f64, at the same grid
   and the mamba2-1.3b and zamba2-1.2b training shapes; and the gradient
   of ``ops.ssd_scan`` (K4 + K5) against autograd through the sequential
   ``ssd_ref``, with and without ``initial_state``;
4. full-width serving of chatglm3-6b (6.24 B parameters, bf16, weights from a
   seeded generator, ``attn_impl="flash"``): 4 requests of 128, 512, 1024 and
   2048 prompt tokens and 32 new tokens each, one ``ServeEngine.generate``
   call each; the flash kernel must launch once per layer and request, and
   every token must be in range;
5. model-level cross-check: the 1024-token prefill through the kernel
   (``flash``) against plain PyTorch (``blocked``), last-position logits;
6. timing: the flash kernel at S=2048 (CUDA events) beside its bound, the
   plain version and ``scaled_dot_product_attention`` (timed here only; the
   port never calls it);
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
    plain version (no single PyTorch call computes this function).

After each model's serving phase, the profiler's kernel time of one prefill
of its longest prompt (with each kernel's share) and of 8 decode steps, beside
the host clock and the device's idle share.
Each serving and training phase sets every kernel's launch count to 0 just
before it and reads the counts just after.  Then one ``{"kernels": [...]}`` line and, last,
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
KERNELS = ("flash_attention", "ssd_scan", "ssd_scan_bwd")
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


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


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
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = list(pool.map(_build.load, KERNELS))
    print(f"[build] {len(builds)} libraries in "
          f"{time.perf_counter() - t0:.2f} s (compiled side by side)")
    for built in builds:
        print(f"[build] {built.name}: nvcc {built.seconds:.2f} s "
              f"({built.path.name})")
        for line in built.log.splitlines():
            if "ptxas info" in line and "Compiling" in line:
                print("[build]  ", line.split("'")[1] if "'" in line else line)
            elif "registers" in line or "spill" in line:
                print("[build]     ", line.strip())

    # 3. kernel vs plain ---------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def compare(B, sq, sk, h, kvh, d, causal, dtype):
        shape_q, shape_kv = (B, h, sq, d), (B, kvh, sk, d)
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtypes[dtype])
                   for s in (shape_q, shape_kv, shape_kv))
        got = fa.flash_attention_bhsd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal).float()
        diff = (got.float() - want).abs()
        tol = KERNEL_TOL[dtype]
        err = diff.max().item()
        used = (diff / (tol + tol * want.abs())).max().item()  # <= 1 passes
        print(f"[check] B={B} Sq={sq} Sk={sk} H={h} KVH={kvh} D={d} "
              f"causal={causal} {dtype}: max|err| {err:.3e}, "
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
        compare(1, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True,
                "bfloat16") for s in (512, 2048))))

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

    def time_ms(fn, iters, warmup=3):
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

    # 6. timing --------------------------------------------------------------
    B, H, KVH, D, S = 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, TIMING_S
    q = torch.randn((B, H, S, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, KVH, S, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, KVH, S, D), generator=gen, device=dev).bfloat16()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel_ms = time_ms(lambda: fa.flash_attention_bhsd(q, k, v, causal=True),
                        50)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                       5, warmup=1)
    library_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                      enable_gqa=True), 50)
    pairs = S * (S + 1) // 2                      # causal (q, k) pairs
    flops = 4 * B * H * D * pairs                 # q.k and p.v
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KVH * S * D)   # q, o; k, v
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    print(f"[time] flash B={B} H={H} KVH={KVH} S={S} D={D} bf16 causal: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
          f"{flops / kernel_ms / 1e9:.1f} TFLOP/s, {bound_ms / kernel_ms:.1%} "
          f"of the bound")
    flash_timing = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "shape": f"B={B} H={H} KVH={KVH} S={S} D={D} bf16 causal"}
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

    if failures:
        fail("; ".join(failures))
    for record in servings:
        print(json.dumps({"serving": record}))
    for record in trainings:
        print(json.dumps({"training": record}))
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
        "share_of_tolerance": main_used,
        "ms": kernel_ms, **flash_timing}, {
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
                 f"broadcast"}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
