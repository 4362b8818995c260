#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card: ``nvidia-smi`` name and power limit, torch's device name, count;
2. the build: ``nvcc`` builds every kernel of the path from ``src/`` (seconds,
   ptxas register and shared-memory lines);
3. kernel vs plain: each kernel against its plain PyTorch version on the card,
   at the unit-test grid and at chatglm3-6b prefill shapes;
4. full-width serving: chatglm3-6b (6.24 B parameters, bf16, weights from a
   seeded generator, ``attn_impl="flash"``) serves 4 requests of 128, 512,
   1024 and 2048 prompt tokens and 32 new tokens each through
   ``ServeEngine.generate``; the flash kernel must launch once per layer and
   request, and every token must be in range;
   then the profiler's kernel time of one 2048-token prefill and of 8 decode
   steps beside the host clock;
5. model-level cross-check: the 1024-token prefill through the kernel
   (``flash``) against plain PyTorch (``blocked``), last-position logits;
6. timing: the kernel at S=2048 (CUDA events) beside its bound, the plain
   version and ``scaled_dot_product_attention`` (timed here only; the port
   never calls it).

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.
There is no CPU path: without a CUDA device the script exits with 1.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "chatglm3-6b"
PROMPT_LENS = (128, 512, 1024, 2048)
NEW_TOKENS = 32
TIMING_S = 2048
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain: the reference's own kernel-test tolerances
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# flash vs blocked logits after 28 bf16 layers, relative to the largest logit
XCHECK_TOL = 2e-2
UNIT_GRID = [  # (B, Sq, Sk, H, KVH, D): the reference's grid, then D=256, 128
    (2, 128, 128, 4, 4, 64), (2, 256, 256, 4, 1, 64), (2, 128, 384, 8, 2, 32),
    (2, 100, 200, 4, 2, 64), (1, 300, 170, 8, 2, 256), (1, 200, 333, 4, 2, 128)]


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

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import params as pr
    from repro_torch.models.lm import build_model
    from repro_torch.serve.engine import ServeEngine

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

    # 2. the build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.load("flash_attention")
    print(f"[build] flash_attention: nvcc {built.seconds:.2f} s, loaded in "
          f"{time.perf_counter() - t0:.2f} s ({built.path.name})")
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

    # 4. full-width serving ------------------------------------------------
    model = build_model(cfg, attn_impl="flash")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pr.leaves(params))
    print(f"[serve] {ARCH}: {n_params / 1e9:.3f} B parameters in bf16 "
          f"({n_params * 2 / 1e9:.2f} GB), drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    if n_params != cfg.param_count():
        fail(f"{n_params} parameters, config says {cfg.param_count()}")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
               for n in PROMPT_LENS]
    engine = ServeEngine(model, params, max_seq=max(PROMPT_LENS) + NEW_TOKENS,
                         device=dev)
    engine.generate([prompts[0][:16]], max_new_tokens=2)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_bhsd.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_bhsd.launches
    peak = torch.cuda.max_memory_allocated()
    want_launches = cfg.n_layers * len(prompts)
    print(f"[serve] flash kernel launches: {launches} (want {want_launches})")
    if launches != want_launches:
        fail(f"flash kernel launched {launches} times, want {want_launches}")
    for n, out in zip(PROMPT_LENS, outs):
        if len(out) != NEW_TOKENS or not all(0 <= t < cfg.padded_vocab
                                             for t in out):
            fail(f"request of {n} tokens returned {out}")
    for t in engine.timings:
        print(f"[serve] prompt {t.prompt_len:5d}: prefill "
              f"{t.prefill_s * 1e3:9.2f} ms, decode "
              f"{t.decode_s * 1e3 / t.decode_steps:7.2f} ms/token "
              f"over {t.decode_steps} tokens")
    new_tokens = sum(len(o) for o in outs)
    decode_s = sum(t.decode_s for t in engine.timings)
    decode_steps = sum(t.decode_steps for t in engine.timings)
    serving = {
        "arch": ARCH, "params": n_params, "dtype": "bfloat16",
        "requests": len(prompts), "prompt_tokens": list(PROMPT_LENS),
        "new_tokens_per_request": NEW_TOKENS, "wall_s": wall,
        "tokens_per_s": new_tokens / wall,
        "prefill_ms": [t.prefill_s * 1e3 for t in engine.timings],
        "decode_ms_per_token": decode_s * 1e3 / decode_steps,
        "peak_mem_bytes": peak, "flash_launches": launches}
    print(f"[serve] {new_tokens} new tokens in {wall:.3f} s "
          f"({serving['tokens_per_s']:.2f} tokens/s); peak memory "
          f"{peak / 2**30:.2f} GiB")

    # 4b. where the device time goes: profiler kernel time of one 2048-token
    # prefill and of 8 decode steps, beside the unprofiled host times above
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernel_seconds(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e6
        flash = sum(e.self_device_time_total for e in kern
                    if "flash_fwd_" in e.name) / 1e6
        return busy, flash

    steps = 8
    with torch.inference_mode():
        long_toks = torch.tensor([prompts[3]], device=dev)
        pre_busy, pre_flash = kernel_seconds(
            lambda: model.prefill_fn(params, {"tokens": long_toks}))
        _, cache = engine._prefill_one(prompts[3])
        tok = torch.zeros((1, 1), dtype=torch.long, device=dev)

        def decode_steps():
            for i in range(steps):
                model.decode_fn(params, cache, {"tokens": tok,
                                                "pos": len(prompts[3]) + i})

        dec_busy, _ = kernel_seconds(decode_steps)
    pre_wall = engine.timings[3].prefill_s
    dec_wall = engine.timings[3].decode_s / engine.timings[3].decode_steps
    if pre_busy > 0 and dec_busy > 0:
        trace = {
            "prefill_2048_kernel_ms": pre_busy * 1e3,
            "prefill_2048_flash_ms": pre_flash * 1e3,
            "prefill_2048_host_ms": pre_wall * 1e3,
            "decode_kernel_ms_per_token": dec_busy * 1e3 / steps,
            "decode_host_ms_per_token": dec_wall * 1e3,
            "decode_device_idle_share": 1 - dec_busy / steps / dec_wall}
        print(f"[trace] prefill 2048: kernels {pre_busy * 1e3:.2f} ms "
              f"(flash {pre_flash * 1e3:.2f} ms, "
              f"{pre_flash / pre_busy:.1%}) of {pre_wall * 1e3:.2f} ms on the "
              f"host clock; decode: kernels "
              f"{dec_busy * 1e3 / steps:.2f} ms/token of "
              f"{dec_wall * 1e3:.2f} ms/token on the host clock (device idle "
              f"{trace['decode_device_idle_share']:.1%})")
    else:
        trace = "not measured"
        print("[trace] the profiler reported no device time: not measured")
    serving["trace"] = trace

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
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": launches, "max_abs_err": main_err,
        "tolerance": f"|err| <= {KERNEL_TOL['bfloat16']} "
                     f"+ {KERNEL_TOL['bfloat16']}|plain|",
        "share_of_tolerance": main_used,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": f"B={B} H={H} KVH={KVH} S={S} D={D} bf16 causal"}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
