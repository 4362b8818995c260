#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and calibration paths on one
NVIDIA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card: ``nvidia-smi`` name and power limit, torch's device name, count;
2. the build: ``nvcc`` builds every kernel of the paths from ``src/`` (K1
   and K2 in ``stream.cu``, K3, K4, K5 and the scan), one compiler per
   source, all started together (seconds, ptxas register, shared-memory
   and spill lines; K3's dynamic shared memory a CTA for each head dim; K5's for
   each instance, with the times it forms s = C.B^T and dM = dy.x^T per
   tile pair; K4's for each instance; the run fails if ptxas reports a
   spill or serialized wgmma (C75xx) for any K4 instance);
3. kernel vs plain: each kernel against its plain PyTorch version on the card:
   flash attention (K3) at the unit-test grid, its tile edges (Sq, Sk of
   127-129 and 2047, G = 16 and 1, every head dim) and the chatglm3-6b and
   zamba2-1.2b prefill shapes on (B, S, H, D) views;
   the SSD chunk kernel (K4) at the reference's grid, a Q < chunk case and the
   mamba2-1.3b and zamba2-1.2b prefill and training shapes, f32 and bf16,
   B/C contiguous and head-broadcast, each run twice for identical bits,
   and where cs rises (outside its factorization's precondition, which it
   checks per head): with dt < 0 on rows of some heads, and with A > 0 on
   some heads (y from f32 inputs there within twice its tolerance, the
   documented limit of its split products), then ``ops.ssd_scan`` with
   ``initial_state`` against
   the split-sequence identity; the SSD backward kernel (K5) against its
   plain version and both against the same math in f64, at the same grid
   and the mamba2-1.3b and zamba2-1.2b training shapes, each run twice for
   identical bits; and the gradient
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
   shapes, S = 2048 and 512, and at whisper-large-v3's encoder (no mask,
   S 1500, H 20, D 64), paligemma-3b's (S 2048, H 8 over one KV head, D
   256) and llama4-scout's (S 2048, H 40 over 8, D 128), on device time
   (each call behind a device-side spin) beside its bound, the plain
   version and ``scaled_dot_product_attention`` (timed here only; the port
   never calls it);
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
10. timing: K4 at mamba2-1.3b's 2048-token prefill shape, its training
    shape (batch 4) and zamba2-1.2b's prefill shape (N 64) on device time
    (each call behind a device-side spin) beside its bound (the larger of
    its tensor-core bound, the f32-operand products counted twice for their
    hi/lo halves, and its byte bound; the bound with those products as f32
    FMAs printed beside them) and its plain version (no single PyTorch
    call computes this function);
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
14. timing: K5 at mamba2-1.3b's training shape on device time beside its
    bound (the larger of its tensor-core and its byte bound; the bound with
    its f32-operand products as f32 FMAs printed beside them), the host's
    time to queue one call, and its plain version (no single PyTorch call
    computes this function);
15. the paper's calibration loop (``repro_torch.core.calibrate``): fit the
    H100 spec from K1 microbenchmarks and print every fitted scalar;
16. the Fig. 3 accuracy tables, all 28 Table-1 kernels timed through K1
    and simulated, at Table 1's n x 1024 and x 16384 (HBM-resident), K1's
    launches counted (28 x (1 + repeats) each), and the O3 sweep's top 8;
17. the Figs. 4/5 Triad sweep: K2 at 1-132 CTAs, at ~3/4 of the L2 and at
    twice it, measured against the saturating-bandwidth model;
18. timing: each K1 expression at the HBM-resident scale and K2 at twice
    the L2 (on device time, each call behind a spin), beside the plain
    version, one PyTorch call where one computes the function, and the
    bound (bytes over 3.35 TB/s, f64 flops counted in
    the SASS over 34 TFLOP/s); each output at these shapes held against the
    plain version's, as in phase 3;
19. Fig. 3 at the scale of a model step: the training steps of phases 11
    and 12 and the 2048-token prefills of phases 4, 7 and 8 captured at
    full width as ATen graphs (``core.aten.capture`` over fake tensors:
    nothing runs, the launch counts must not move, and at most 1 MiB of
    device memory may be taken, none of it the model's), the prefills on
    the kernel path and on the plain path (``blocked``, ``chunked``; its
    prefill timed here); each capture's
    kernel custom ops must equal the launches its phase counted a step or a
    request (K4 96 and K5 48 for mamba2-1.3b's step, ...); each is
    simulated against the H100 fitted in phase 15 with both engines and
    printed beside the measured kernel time and host clock, with the
    differences and the seconds that capture and simulation took;
20. the node engine and the simulator's own scan (``kernels.sched_scan``,
    ``csrc/sched_scan.cu``, built in phase 2): J1, ``schedule_batch`` over
    calibrate's 90-combo O3 grid for each of phase 19's captures against
    the H100 of phase 15; J2, ``schedule_node_sweep`` at 12 and 48 cores,
    shard, under ``A64FX_CORE`` + ``A64FX_NODE`` on a 10k-op DAG and on
    mamba2-1.3b's 26,181-op training step, and ``schedule_node_batch`` at 48
    cores, round-robin and graph, on the DAG; each with
    ``backend="torch"`` and ``backend="numpy"``, 0 elements differing, the
    kernel's launches counted; the kernel against its plain version on the
    card at the first passes' inputs, its device time beside its bound (a
    pointer chase times the dependent load of the chain floor); and
    ``simulate(engine="node")`` of the step on 48 cores with its PA
    report's node section;
21. full-width serving of whisper-large-v3 (1.60 B parameters, 32 encoder
    and 32 decoder layers): 3 requests of 64, 224 and 448 tokens and 32 new
    tokens each with seeded (1, 1500, 1280) frames as ``extra_inputs``; K3
    must launch (32 + 32) x 3 times (the encoder without a mask, the
    decoder's self-attention; cross-attention runs blocked, as in the
    reference); then the 448-token prefill through ``flash`` against
    ``blocked`` with the same weights in f32 (last-position logits within
    1e-3 of the largest, the same argmax);
22. the same for paligemma-3b (2.51 B parameters, 18 layers, D 256 over one
    KV head): seeded (1, 256, 2048) image embeddings, 3 requests of 256
    image rows plus 64, 768 and 1792 text tokens (no prompt shorter than
    the image rows, which would change the sequence length); K3 18 x 3
    times; the f32 cross-check at 1024 tokens;
23. the same for llama4-scout-17b-a16e at full width and 8 of its 48 layers
    (19.69 B parameters, 39.4 GB; 16 experts top-1 and a shared expert): 4
    requests of 128-2048 tokens, K3 8 x 4 times, the assignments each
    request's prefill and decode dropped at capacity; the f32 cross-check
    at 2 layers and 1024 tokens;
24. the int8 KV cache on qwen1.5-32b at full width and 16 of its 64 layers:
    one 2048-token prefill (K3 16 times), its k/v quantized by
    ``quantize_kv`` into an int8 ``init_cache`` of 2080 positions, 32
    ``decode_fn`` steps over it and the same tokens over a bf16 cache
    (ms/token, the logits' distance, the profiler's view of each), and
    ``decode_attention_q8`` held against naive attention over the
    dequantized cache in f32 at these shapes; the cache's bytes a token and
    layer in int8 and bf16 (``ServeEngine.generate`` takes no int8 cache,
    as in the reference); then phase 19 for whisper's and llama4's longest
    prefill (whisper's with its 1500-frame encoder), each capture's K3
    calls held against the launches its phase counted a request;
25. sampled estimation at full width (``core.sample``): phase 19's seven
    kernel-path captures (the two training steps, the five prefills)
    sampled with ``SamplingConfig()`` and swept over the zoo's 12-combo
    O3 grid at 1/12/48 cores of ``A64FX_NODE``, sampled and in full,
    through the scan kernel; the error, the share of op instances
    scheduled, the wall seconds and the scan's launches and device time
    of each; ``full_interval_estimate`` and k >= n_intervals bit-identical
    at 12 cores; mamba2-1.3b's sampled sweep bit for bit with NumPy;
26. the model zoo (``core.zoo.run_zoo``): all ten architectures' train,
    prefill and decode cells captured at reduced width over fake CPU
    tensors, estimated at 1/12/48 cores with the O3 grid on the scan
    kernel; zamba2-1.2b's train cell bit for bit with NumPy; the Kendall
    taus across core counts (at least 0.5, the reference's floor) and
    against ``BENCH_model_zoo.json``'s ranks;
27. the calibration CLIs: ``tools/kernel_suite_torch.py --quick`` (K1
    through ``fit_h100`` and the Fig. 3 table) and ``tools/triad_torch.py
    --quick`` (K2), their JSON held to its schema;
28. hardware DSE (``core.dse``): phase 19's seven kernel-path captures
    each swept over the 64-candidate A64FX-like grid (``spec_grid(
    generate_grid())``) on the scan kernel, the grid's host compile timed
    apart, the scan's launches, elements and device time, the best
    candidate, the Pareto front and the ranks' Kendall tau across the
    seven; mamba2-1.3b's step on NumPy too, 0 of 64 elements differing;
    ``run_dse`` on the reference bench's ten zoo workloads on the scan,
    with the tau of each against ``BENCH_dse.json``'s ranks; and
    ``tools/dse_sweep_torch.py --quick`` (fused sweep on the scan against
    the per-spec loop: bit-identical, at least 10x);
29. the serving simulator (``core.serving``): ``tools/serving_sweep_torch.py
    --quick`` and its three gates; ``build_zoo_cost_model`` for
    chatglm3-6b, qwen1.5-32b, llama4-scout-17b-a16e and mamba2-1.3b from
    the port's captures and the six-policy sweep at 600 requests (A64FX-node
    estimates of the models, not card times), the KV bytes a token equal
    to ``BENCH_serving.json``'s; then ``examples/serve_lm_torch.py``: the
    reduced chatglm3-6b and mamba2-1.3b (vocab 256) trained 500 steps in
    f32 on a Markov rule and served through K3 (f32, D 32) and K4, the
    rule-following accuracy above 0.5 for each; each shape, dtype and B/C
    layout the example launched K3, K4 or K5 at (K3 B 1, S 24, H 4 over
    one KV head; K4 and K5 B 32, nc 4, Q 16, H 16, P 16, N 16, broadcast
    B/C; K4 also B 1, nc 2) recorded around its launches and the kernel
    held there against its plain version;
30. meshes (``parallel/``) on a 1x1 ("data", "model") ``DeviceMesh`` over
    a one-rank NCCL group: mamba2-1.3b at full width and all 48 layers,
    trained by ``launch.train.train_loop`` for 3 steps of 4 x 2048 tokens
    without and with the mesh from the same seed and batches (the losses
    within 1e-6 relative, equal bits expected; K4 288 and K5 144 launches
    in each; the step's host ms side by side); an 8-layer state after one
    step without the mesh written by ``AsyncCheckpointer``, restored onto
    the mesh by ``restore(shardings=)`` bit for bit and stepped once (a
    finite loss);
    chatglm3-6b at full width served by ``ServeEngine`` and
    ``ServeEngine(rules=)``, 2 requests of 128 and 2048 tokens and 16 new
    tokens (the same greedy tokens, K3 56 launches in each); every shape
    the phase launched K3, K4 and K5 at held against the plain versions;
    then ``tools/cluster_scaling_torch.py --quick`` (equal to the
    reference's ``--quick``) and its full run on the host, with the ranks
    and plan taus against ``BENCH_cluster.json``;
31. ``examples/train_lm_torch.py`` at ``--size 100m`` and the reference
    example's defaults but **200 steps** (of 8 x 256 tokens, microbatch 4,
    f32, checkpoints every 25 steps, a failure injected at step 100): one
    restart, the loss falling by more than 0.5, step ms, tokens/s, a
    checkpoint's save and restore seconds; the resumed losses from the
    restored step to the step after the fault equal to an uninterrupted
    run's (bits, else 1e-5 relative); no hand-written kernel on its path;
32. ``tools/ssd_kernel_cost_torch.py`` (the plain chunked SSD path's
    captured bytes and FLOPs against K4's and K5's bounds, as memory and
    compute terms on ``H100``, at mamba2-1.3b train_4k's per-device shape)
    beside the card's device time there of K4 + K5, the kernel path's and
    the plain path's forward + backward; K4 and K5 launched once each by
    the kernel path and held against their plain versions there;
33. ``tools/cell_capture_torch.py``: chatglm3-6b's decode_32k cell
    captured at full width on the fake (16, 16) and (2, 16, 16) production
    meshes, each in a process of its own (256 and 512 fake ranks), started
    before phase 31 and run beside phases 31-32 (host work), parsed and
    simulated: capture and parse seconds, peak resident memory (host
    numbers), graph nodes, ops, collective bytes by kind and group size,
    the ops that move the most, t_est on ``H100``;
34. ``python -m repro_torch.launch.dryrun --jobs 2`` on chatglm3-6b
    prefill_32k and mamba2-1.3b decode_32k (the fake (16, 16) mesh) and
    ``launch.analyze`` on phase 33's cell, started after phase 31 and run
    beside phases 32-33 and ``[mem]``; each cell's capture seconds, peak
    resident memory, peak
    bytes a rank, collectives by kind and dominant term;
    ``tools/roofline_table_torch.py`` on the artifacts; a Shard(0) ->
    Shard(1) redistribution captured as one all-to-all (``[dryrun]``
    lines); then ``[mem]``: ``core.aten.memory_analysis``'s output + temp
    bytes of phase 19's mamba2-1.3b training step and chatglm3-6b 2048-token
    prefill beside the allocator's peak of one real run of each, within
    0.5-1.05 of it.

The models are freed between phases.  After each model's serving phase,
the profiler's kernel time of one prefill
of its longest prompt (with each kernel's share) and of 8 decode steps, beside
the host clock and the device's idle share.
Each serving and training phase sets every kernel's launch count to 0 just
before it and reads the counts just after; so does the calibration path
for K1 and K2, phase 20 for the scan around each case's torch run,
phases 25, 26 and 28 for the scan around each sweep, phase 27 for K1 and
K2, phase 29 for K3, K4 and K5 around each model of ``serve_lm``, phase
30 around each 48-layer training run, the restored step and each engine
(the one step that makes the restored state goes uncounted), phase 31
around ``train_lm`` and phase 32 around the kernel path's one run.
Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  There is no CPU path: without a CUDA device
the script exits with 1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
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
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# ``repro_torch.kernels.bounds``' PEAK_BF16_FLOPS, PEAK_F32_FLOPS (CUDA-core
# FMAs, the bounds' f32 variants) and HBM_BYTES_PER_S, set by ``main``
PEAK_BF16_FLOPS = PEAK_F32_FLOPS = HBM_BYTES_PER_S = None
KERNELS = ("flash_attention", "ssd_scan", "ssd_scan_bwd")  # model paths
SOURCES = (*KERNELS, "stream", "sched_scan")   # csrc/*.cu, side by side
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
# K3 timing: chatglm3-6b's and zamba2-1.2b's attention at S = 2048 and 512,
# then the moe, vlm and audio families' new shapes: whisper-large-v3's
# encoder (no mask, S 1500), paligemma-3b's (D 256, one KV head) and
# llama4-scout's (40 heads over 8 KV heads) at S 2048: (label, H, KVH, D, S,
# causal)
FLASH_TIMING = [("chatglm3-6b", 32, 2, 128, 2048, True),
                ("zamba2-1.2b", 32, 32, 64, 2048, True),
                ("chatglm3-6b", 32, 2, 128, 512, True),
                ("zamba2-1.2b", 32, 32, 64, 512, True),
                ("whisper-large-v3 encoder", 20, 20, 64, 1500, False),
                ("paligemma-3b", 8, 1, 256, 2048, True),
                ("llama4-scout-17b-a16e", 40, 8, 128, 2048, True)]
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
# A of heads 0-3 where K4's check of cs rising takes A > 0: the CPU
# precision test's values (tests/_ssd_split.py)
RISING_A = (-0.5, 0.002, -0.3, 0.005)
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
# phases 21-24: the audio, vlm and moe families and the int8 KV cache at
# full width; llama4-scout and qwen1.5-32b cut in depth to fit one card
WHISPER_ARCH, WHISPER_PROMPT_LENS = "whisper-large-v3", (64, 224, 448)
# paligemma: 256 image rows and 64, 768 and 1792 text tokens (a prompt
# shorter than the image rows would change the sequence length)
VLM_ARCH, VLM_PROMPT_LENS = "paligemma-3b", (320, 1024, 2048)
MOE_ARCH, MOE_LAYERS, MOE_XCHECK_LAYERS = "llama4-scout-17b-a16e", 8, 2
Q8_ARCH, Q8_LAYERS, Q8_PROMPT = "qwen1.5-32b", 16, 2048
# decode_attention_q8 against naive attention over the dequantized cache,
# both in f32 (summation order only): the reference's f32 kernel-test
# tolerance, |err| <= 2e-5 + 2e-5|naive|
Q8_TOL = 2e-5
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
TRIAD_REPEATS = 50
# Triad (Figs. 4/5): about 3/4 of the 50 MB L2 and twice it, in f64
TRIAD_L2_N, TRIAD_MEM_N = 184 * 8192, 1 << 22
TRIAD_SIZE_NS = (1 << 22, 1 << 24, 1 << 26)   # K2's fixed cost and rate
TRIAD_CTAS = (1, 2, 4, 8, 16, 33, 66, 132)
# K2 checks: both sweep sizes; 37 x 8192, no multiple of the full grid (264
# CTAs of 1024 threads) nor of 33 or 132 CTAs; 5000, no multiple of any grid;
# every cap of the sweep and the full grid
TRIAD_CHECK_NS = (TRIAD_L2_N, TRIAD_MEM_N, 37 * 8192, 5000)
TRIAD_CHECK_CTAS = (*TRIAD_CTAS, None)


def bit_identical(xs, ys) -> bool:
    """Two runs' outputs hold the same bits (f32 or bf16 tensors)."""
    import torch
    return all(torch.equal(a.view(torch.int16 if a.element_size() == 2
                                  else torch.int32),
                           b.view(torch.int16 if b.element_size() == 2
                                  else torch.int32))
               for a, b in zip(xs, ys))


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


def device_ms(fn, repeats):
    """Median milliseconds of ``fn()`` on the card over ``repeats`` calls,
    each queued behind a device-side spin longer than the host takes to
    queue the call (``core/calibrate.py``'s ``_median_time``), so the events
    around it time the card, not the wrapper's per-call host cost."""
    import torch

    from repro_torch.core import calibrate as cal
    return cal._median_time(lambda _: fn(), (torch.empty(0, device="cuda"),),
                            repeats) * 1e3


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
            "launches": launches}, hw


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
    k2 = {"ms": device_ms(lambda: stream.stream_triad(a, b, 3.0),
                          TRIAD_REPEATS),
          "plain_ms": device_ms(lambda: stream.stream_triad_plain(a, b, 3.0),
                                TRIAD_REPEATS),
          "library_ms": device_ms(lambda: torch.add(a, b, alpha=3.0),
                                  TRIAD_REPEATS),
          "timing": "device time: the median of calls each behind a "
                    "device-side spin"}
    t_bytes, t_ops = 3 * 8 * n / HBM_BYTES_PER_S, 2 * n / PEAK_F64_FLOPS
    k2.update(bound_ms=max(t_bytes, t_ops) * 1e3,
              bound_by="operations" if t_ops > t_bytes else "bytes",
              shape=f"n={n} f64 (2x L2), grid filling the card")
    print(f"[time] K2 n={n} f64 (device time, the median of {TRIAD_REPEATS} "
          f"calls behind a spin): kernel {k2['ms'] * 1e3:.2f} us, plain "
          f"{k2['plain_ms'] * 1e3:.2f} us, torch.add(a, b, alpha=3) "
          f"{k2['library_ms'] * 1e3:.2f} us, bound {k2['bound_ms'] * 1e3:.2f}"
          f" us ({3 * 8 * n / 1e6:.1f} MB over {HBM_BYTES_PER_S / 1e12:g} "
          f"TB/s); kernel at {3 * 8 * n / k2['ms'] / 1e6:.0f} GB/s; vs plain "
          f"max|err| {k2_err:.3e}, {k2_differ} not bit-identical")
    # K2 and torch.add at 4x and 16x that size: how much of the gap to the
    # byte bound is a fixed cost of each launch (start, ramp, drain) and how
    # much the rate that the card sustains
    del a, b
    k2["by_size"] = []
    for n in TRIAD_SIZE_NS:
        a = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
        b = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
        row = {"n": n,
               "ms": device_ms(lambda: stream.stream_triad(a, b, 3.0),
                               TRIAD_REPEATS),
               "library_ms": device_ms(lambda: torch.add(a, b, alpha=3.0),
                                       TRIAD_REPEATS),
               "bound_ms": 3 * 8 * n / HBM_BYTES_PER_S * 1e3}
        k2["by_size"].append(row)
        print(f"[time] K2 n={n} f64 ({3 * 8 * n / 1e6:.1f} MB; device time "
              f"behind a spin): kernel {row['ms'] * 1e3:.2f} us "
              f"({row['bound_ms'] / row['ms']:.1%} of the byte bound), "
              f"torch.add {row['library_ms'] * 1e3:.2f} us "
              f"({row['bound_ms'] / row['library_ms']:.1%})")
        del a, b
    (n0, t0), (n1, t1) = ((r["n"], r["ms"]) for r in k2["by_size"][-2:])
    rate = 3 * 8 * (n1 - n0) / ((t1 - t0) * 1e-3)
    print(f"[time] K2: from the two largest sizes, {rate / 1e12:.3f} TB/s "
          f"sustained ({rate / HBM_BYTES_PER_S:.1%} of "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s) and a fixed "
          f"{(t1 - 3 * 8 * n1 / rate * 1e3) * 1e3:.2f} us a launch")
    return {"k1": rows, "k2": k2, "k1_err": k1_err, "k1_used": k1_used,
            "k2_err": k2_err, "k2_used": k2_used}


# phase 19: each capture's kernel custom ops, by launch counter
CUSTOM_OPS = {"flash_attention": "flash_attention",
              "ssd_scan": "ssd_chunk_fwd", "ssd_scan_bwd": "ssd_chunk_bwd"}
# the device memory a capture may take: none of the model's, only the
# 4-byte constants that a step makes from Python numbers (the loss's aux
# term) and the fake-tensor mode's context, in 512-byte blocks (1.5 KiB
# seen on the card)
CAPTURE_MEM_BYTES = 1 << 20


def custom_calls(gm) -> dict:
    """The kernel custom ops a captured graph holds, by launch counter."""
    got = dict.fromkeys(CUSTOM_OPS, 0)
    for n in gm.graph.nodes:
        if getattr(n.target, "namespace", None) == "repro_torch":
            name = n.target.overloadpacket.__name__
            got[next(k for k, v in CUSTOM_OPS.items() if v == name)] += 1
    return got


def fake_params(model, dtype, dev):
    """The model's parameters as tensors of the current fake mode."""
    import torch

    from repro_torch.models import params as pr
    return pr.tree_map(lambda p: torch.empty(p.shape, dtype=dtype,
                                             device=dev),
                       model.param_specs())


def prefill_of(model):
    import torch

    def prefill(params, batch):
        with torch.no_grad():
            return model.prefill_fn(params, batch)
    return prefill


def capture_and_simulate(dev, hw, label, fn, make_args, want, measured,
                         programs=None) -> dict:
    """Capture ``fn(*make_args())`` over fake tensors, hold its kernel custom
    calls against ``want`` (the launches its phase counted), simulate it
    against ``hw`` with both engines and print it beside ``measured``
    (kernel ms, host ms).  Appends (label, Program) to ``programs``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import aten
    from repro_torch.core.simulate import simulate

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    with FakeTensorMode():
        args = make_args()
    t0 = time.perf_counter()
    gm = aten.capture(fn, *args)
    t_capture = time.perf_counter() - t0
    taken = torch.cuda.max_memory_allocated() - mem0 if on_card else 0
    if taken > CAPTURE_MEM_BYTES:
        fail(f"{label}: the capture took {taken} B of device memory")
    calls = custom_calls(gm)
    print(f"[fig3-step] {label}: captured {len(gm.graph.nodes)} graph "
          f"nodes in {t_capture:.1f} s, {taken} B of device memory at "
          f"its peak; kernel custom calls {calls} (want {want})")
    if calls != want:
        fail(f"{label}: the capture holds kernel calls {calls}, the "
             f"phase launched {want}")
    t0 = time.perf_counter()
    rep = simulate(gm, hw=hw, compute_dtype="bf16", engine="both",
                   title=label)
    t_sim = time.perf_counter() - t0
    memory = aten.memory_analysis(gm)        # phase 34's [mem] reads it
    del gm
    if programs is not None:
        programs.append((label, rep.program))
    classes = rep.program.by_class()
    occ_ms, sched_ms = rep.engine.t_est * 1e3, rep.schedule.t_est * 1e3
    kernel_ms, host_ms = measured
    row = {"capture": label, "ops": len(rep.program.ops),
           "custom_calls": calls,
           "gflop": {k: v["flops"] / 1e9 for k, v in classes.items()},
           "gb": {k: v["bytes"] / 1e9 for k, v in classes.items()},
           "occupancy_ms": occ_ms, "schedule_ms": sched_ms,
           "kernel_ms": kernel_ms, "host_ms": host_ms,
           "capture_s": t_capture, "simulate_s": t_sim,
           "memory_analysis": memory}
    diffs = []
    for sim_key, sim_ms in (("occupancy", occ_ms), ("schedule", sched_ms)):
        for meas_key, meas_ms in (("kernel", kernel_ms), ("host", host_ms)):
            d = (100 * (sim_ms - meas_ms) / meas_ms
                 if meas_ms else None)
            row[f"{sim_key}_vs_{meas_key}_pct"] = d
            diffs.append(f"{sim_key} vs {meas_key} "
                         + ("not measured" if d is None else f"{d:+.1f} %"))
    print(f"[fig3-step] {label}: {row['ops']} ops; GFLOP "
          + ", ".join(f"{k} {v:.2f}" for k, v in row["gflop"].items())
          + "; GB " + ", ".join(f"{k} {v:.3f}"
                                for k, v in row["gb"].items())
          + f"; simulated {occ_ms:.2f} ms (occupancy), {sched_ms:.2f} ms "
          f"(schedule); measured "
          + ("not measured" if kernel_ms is None else
             f"{kernel_ms:.2f} ms kernel time, {host_ms:.2f} ms host "
             f"clock")
          + "; " + ", ".join(diffs)
          + f"; capture {t_capture:.1f} s, simulate {t_sim:.1f} s")
    return row


def traced(record, kernel_key, host_key):
    """(kernel ms, host ms) of a phase's traced prefill or step."""
    tr = record["trace"]
    if not isinstance(tr, dict):
        return None, None
    return tr[kernel_key], tr[host_key]


def fig3_steps(dev, hw, servings, trainings, timed, read_launches,
               programs) -> list:
    """Phase 19, Fig. 3 at the scale of a model step: capture the two
    training steps and the three 2048-token prefills at full width (fake
    tensors: nothing runs on the card, none of the model's memory is
    taken), the prefills
    also on the plain path; hold each capture's custom ops against the
    launches its phase counted, simulate it against the fitted ``hw`` with
    both engines, and print the simulated beside the measured times: the
    profiler's kernel time and the host clock of the phase's traced step or
    prefill (for the plain path, measured here by ``timed``).  Each
    capture's parsed program is appended to ``programs`` as (label,
    Program), for phase 20."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, RunConfig, ShapeConfig
    from repro_torch.models.lm import build_model
    from repro_torch.train.trainer import make_train_step

    launches_before = read_launches()

    def one(label, fn, make_args, want, measured):
        return capture_and_simulate(dev, hw, label, fn, make_args, want,
                                    measured, programs)

    rows = []
    # the training steps: RunConfig's defaults, the kernel path of phases
    # 11 and 12 (K4 forward and its recompute, K5; attention blocked)
    for record, arch in zip(trainings, (SSM_ARCH, HYBRID_ARCH)):
        cfg = ARCHS[arch]
        batch = record["batch"]
        run = RunConfig(model=cfg, shape=ShapeConfig("smoke", TRAIN_SEQ,
                                                     batch, "train"))
        model = build_model(cfg, ssd_impl="kernel")
        step, *_, opt_init = make_train_step(model, run)
        dtype = getattr(torch, run.param_dtype)

        def args(model=model, opt_init=opt_init, dtype=dtype, batch=batch):
            params = fake_params(model, dtype, dev)
            return (params, opt_init(params),
                    {"tokens": torch.zeros((batch, TRAIN_SEQ),
                                           dtype=torch.long, device=dev)})
        want = {k: v // record["steps"] for k, v in record["launches"].items()}
        if want != {"flash_attention": 0, "ssd_scan": 2 * cfg.n_layers,
                    "ssd_scan_bwd": cfg.n_layers}:
            fail(f"{arch}: phase launches {record['launches']}")
        rows.append(one(f"{arch} training step {batch} x {TRAIN_SEQ}, kernel "
                        f"path", step, args, want,
                        traced(record, "kernel_ms", "host_ms")))
        gc.collect()
    # the 2048-token prefills of phases 4, 7 and 8, on the kernel path
    # (flash, K4) and on the plain path (blocked, chunked)
    for record in servings:
        arch = record["arch"]
        cfg = ARCHS[arch]
        n = max(record["prompt_tokens"])
        n_req = record["requests"]
        want = {k: v // n_req for k, v in record["launches"].items()}
        n_inv = (len(range(0, cfg.n_layers, cfg.shared_attn_every))
                 if cfg.family == "hybrid" else cfg.n_layers)
        expect = {"flash_attention": n_inv if cfg.family != "ssm" else 0,
                  "ssd_scan": cfg.n_layers if cfg.family != "dense" else 0,
                  "ssd_scan_bwd": 0}
        if want != expect:
            fail(f"{arch}: serving launches {record['launches']}, want "
                 f"{expect} a request")

        def args(n=n):
            return ({"tokens": torch.zeros((1, n), dtype=torch.long,
                                           device=dev)},)
        for path, attn, ssd_impl in (("kernel", "flash", "kernel"),
                                     ("plain", "blocked", "chunked")):
            model = build_model(cfg, attn_impl=attn, ssd_impl=ssd_impl)
            if path == "kernel":
                measured = traced(record, "prefill_kernel_ms",
                                  "prefill_host_ms")
                calls = want
            else:
                measured = timed(model, n)
                calls = dict.fromkeys(CUSTOM_OPS, 0)
            rows.append(one(
                f"{arch} prefill {n}, {path} path", prefill_of(model),
                lambda model=model: (fake_params(model, torch.bfloat16, dev),
                                     *args()), calls, measured))
            gc.collect()
    if read_launches() != launches_before:
        fail(f"the captures moved the launch counters: {launches_before} -> "
             f"{read_launches()}")
    diffs = [abs(r["occupancy_vs_kernel_pct"]) for r in rows
             if r["occupancy_vs_kernel_pct"] is not None]
    print(f"[fig3-step] diff % = 100 (simulated - measured) / measured; "
          f"median |diff| of the occupancy estimate from the kernel time over "
          f"{len(diffs)} captures: {np.median(diffs):.1f} %")
    return rows


# phase 20: the node engine and the simulator's own scan
SCAN_CORE_COUNTS = (12, 48)        # the shard sweep's core counts (J2)
SCAN_STREAMS = 48                  # J2's op partitions: a stream a core
SCAN_STEP = "mamba2-1.3b training step"     # phase 19's 26,181-op capture


def node_section(pa: str) -> list:
    """The PA report's node-engine lines."""
    lines = pa.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("  node engine ("))
    end = next((i for i in range(start + 1, len(lines))
                if not lines[i].startswith("    ")), len(lines))
    return lines[start:end]


def node_engine(dev, hw, captures) -> dict:
    """Phase 20, the batched schedulers through the scan kernel
    (``kernels.sched_scan``) against their NumPy passes, 0 elements
    differing in every case:

    * J1, ``schedule_batch`` (the reference's ``schedule_batch_jax``):
      calibrate's 90-combo O3 grid for each of phase 19's captures, against
      the H100 fitted in phase 15;
    * J2, the node engine (``_node_pass_batch_jax``): ``schedule_node_sweep``
      at core counts (12, 48), shard, under ``A64FX_CORE`` + ``A64FX_NODE``
      on the 10k-op DAG of ``tools/sched_throughput_torch.py`` and on the
      mamba2-1.3b training step; ``schedule_node_batch`` at 48 cores,
      round-robin and graph, on the DAG (48 streams, the ring addend);

    each with both backends' wall seconds, op-instances a second, the
    kernel's launches and device time (CUDA events around each launch).
    Then the kernel against its plain version on the card at the inputs of
    J1's and J2's first passes on the step (and of the DAG's 48-stream
    pass), its device time there beside its bound: the larger of the bytes
    it must move over 3.35 TB/s and a chain floor, n dependent
    shared-memory loads, timed by a pointer chase here (the L2's beside
    it). Last, ``simulate(engine="node")`` of the step on 48 cores, its PA
    report's node section printed."""
    import numpy as np
    import torch

    from repro_torch.core import calibrate as cal
    from repro_torch.core import compiled, node
    from repro_torch.core.hwspec import A64FX_CORE, A64FX_NODE
    from repro_torch.core.simulate import simulate
    from repro_torch.kernels import sched_scan
    sys.path.insert(0, str(ROOT / "tools"))
    from sched_throughput_torch import compare, synthetic_program

    t_phase = time.perf_counter()
    combos = [(w, mw, vw, qd) for w in cal.O3_WINDOWS
              for mw in cal.O3_MEM_WIDTHS for vw in cal.O3_VPU_WIDTHS
              for qd in cal.O3_QUEUE_DEPTHS]
    shared_ns = sched_scan.pointer_chase_ns("shared", dev)
    l2_ns = sched_scan.pointer_chase_ns("l2", dev)
    print(f"[scan] dependent load, pointer chase on the card: shared memory "
          f"{shared_ns:.2f} ns, L2 (past the L1) {l2_ns:.2f} ns")
    step = next(p for label, p in captures if label.startswith(SCAN_STEP))
    dag = synthetic_program()

    def show(row):
        first = row["first_launch"]
        print(f"[scan] {row['case']}: {row['n_ops']} ops, {row['elements']} "
              f"elements, {row['passes_elements']} element passes "
              f"({row['scheduled_ops']} op-instances); numpy "
              f"{row['numpy_s']:.3f} s ({row['numpy_ops_per_s']:.3e} op/s), "
              f"torch {row['torch_s']:.3f} s ({row['torch_ops_per_s']:.3e} "
              f"op/s, {row['speedup']:.2f}x); {row['launches']} launches, "
              f"{row['kernel_ms']:.3f} ms of kernel time (first launch "
              f"{first['elements']} elements {first['ms']:.3f} ms); "
              f"{row['differing']} elements differ")
        if not row["launches"]:
            fail(f"{row['case']}: the scan kernel was not launched")
        return row

    cases = []
    hw_grid = compiled.O3Knobs.from_grid(hw, combos)
    for label, prog in captures:                                   # J1
        cp = compiled.compile_program(prog, hw, compute_dtype="bf16")
        cases.append(show(compare(
            f"J1 schedule_batch, {label}",
            lambda b, d, cp=cp: compiled.schedule_batch(cp, hw_grid, b, d),
            cp.n, dev)))
    a64_grid = compiled.O3Knobs.from_grid(A64FX_CORE, combos)
    ncs = {}
    for label, prog in (("10k-op DAG", dag), (SCAN_STEP, step)):   # J2
        nc = ncs[label] = node.compile_node(prog, A64FX_CORE,
                                            compute_dtype="bf16")
        cases.append(show(compare(
            f"J2 schedule_node_sweep {SCAN_CORE_COUNTS} shard, {label}",
            lambda b, d, nc=nc: node.schedule_node_sweep(
                nc, A64FX_CORE, a64_grid, SCAN_CORE_COUNTS, A64FX_NODE,
                "shard", backend=b, device=d).ravel(), nc.n, dev)))
    for part in ("round-robin", "graph"):
        cases.append(show(compare(
            f"J2 schedule_node_batch {SCAN_STREAMS} cores {part}, 10k-op DAG",
            lambda b, d, part=part: node.schedule_node_batch(
                ncs["10k-op DAG"], A64FX_CORE, a64_grid, SCAN_STREAMS,
                A64FX_NODE, part, backend=b, device=d).t_est,
            len(dag.ops), dev)))

    # the kernel against its plain version at the first passes' inputs
    def first_pass(what, st, durs, knobs):
        args = (torch.from_numpy(np.ascontiguousarray(durs)).to(dev),
                *sched_scan.knob_tensors(knobs.window, knobs.width,
                                         knobs.depth, dev))
        if durs.shape[1] != knobs.batch:
            args = (args[0].expand(st.n, knobs.batch), *args[1:])
        got = sched_scan.node_scan(st, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = sched_scan.node_scan_plain(st, *args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        differ = int((got.view(torch.int64) != plain.view(torch.int64))
                     .sum())
        if differ:
            fail(f"{what}: the scan kernel differs from its plain version in "
                 f"{differ} elements")
        ms = time_ms(lambda: sched_scan.node_scan(st, *args), 5, warmup=1)
        M = knobs.batch
        nbytes = sched_scan.scan_bytes(st, durs.shape[1], knobs.window,
                                       knobs.width, knobs.depth)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        chain_ms = st.n * shared_ns * 1e-6
        row = {"case": what, "n_ops": st.n, "streams": st.n_streams,
               "elements": M, "ms": ms, "plain_ms": plain_ms,
               "bytes": nbytes, "bytes_ms": bytes_ms, "chain_ms": chain_ms,
               "bound_ms": max(bytes_ms, chain_ms),
               "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
               "ns_per_op": ms * 1e6 / st.n, "differing": differ}
        print(f"[scan] kernel vs plain, {what}: {st.n} ops, {st.n_streams} "
              f"stream(s), {M} elements: 0 of {M} differ; kernel {ms:.3f} "
              f"ms ({row['ns_per_op']:.1f} ns an op), plain (on the card) "
              f"{plain_ms:.1f} ms; bound {row['bound_ms']:.4f} ms by "
              f"{'bytes' if bytes_ms >= chain_ms else 'the chain'}: bytes "
              f"{nbytes / 1e6:.2f} MB = {bytes_ms:.4f} ms, chain {st.n} x "
              f"{shared_ns:.2f} ns = {chain_ms:.4f} ms (L2 chain {st.n} x "
              f"{l2_ns:.2f} ns = {st.n * l2_ns * 1e-6:.3f} ms); kernel at "
              f"{row['bound_ms'] / ms:.1%} of the bound; no PyTorch call "
              f"computes this function")
        return row

    timed = []
    cp = compiled.compile_program(step, hw, compute_dtype="bf16")
    timed.append(first_pass(f"J1 {SCAN_STEP}", compiled.scan_structure(cp, dev),
                            cp.durations[:, None], hw_grid))
    for label in (SCAN_STEP, "10k-op DAG"):
        nc = ncs[label]
        nb = node.compile_node_batch(nc, A64FX_CORE, max(SCAN_CORE_COUNTS),
                                     A64FX_NODE, "shard")
        cols = []
        for k in SCAN_CORE_COUNTS:
            ctx = node._batch_context(nb, k)
            inv_r, inv_w = node._eff_inv(nc, A64FX_NODE, ctx["cores"],
                                         ctx["n_active"])
            cols.append(np.repeat(node._contended_durs_arr(
                nc, inv_r[0], inv_w[0], ctx["scale"])[:, None],
                a64_grid.batch, axis=1))
        tiled = compiled.O3Knobs(
            window=np.tile(a64_grid.window, len(SCAN_CORE_COUNTS)),
            width=np.tile(a64_grid.width, (len(SCAN_CORE_COUNTS), 1)),
            depth=np.tile(a64_grid.depth, (len(SCAN_CORE_COUNTS), 1)))
        timed.append(first_pass(f"J2 shard {label}",
                                node.scan_structure(nb, dev),
                                np.concatenate(cols, axis=1), tiled))
    nb = node.compile_node_batch(ncs["10k-op DAG"], A64FX_CORE, SCAN_STREAMS,
                                 A64FX_NODE, "round-robin")
    timed.append(first_pass(
        f"J2 {SCAN_STREAMS} streams round-robin 10k-op DAG",
        node.scan_structure(nb, dev), ncs["10k-op DAG"].cp.durations[:, None],
        a64_grid))

    t0 = time.perf_counter()
    rep = simulate(step, hw=A64FX_CORE, compute_dtype="bf16", engine="node",
                   n_cores=SCAN_STREAMS, topology=A64FX_NODE,
                   title=SCAN_STEP)
    t_report = time.perf_counter() - t0
    if not (rep.node.t_zero_contention <= rep.node.t_est
            and np.isfinite(rep.node.t_est)):
        fail(f"the node engine's estimate {rep.node.t_est} is below its "
             f"zero-contention bound {rep.node.t_zero_contention}")
    print(f"[scan] simulate({SCAN_STEP}, A64FX_CORE, engine='node', "
          f"n_cores={SCAN_STREAMS}, topology=A64FX_NODE) in {t_report:.1f} "
          f"s; its PA report's node section:")
    for line in node_section(rep.pa):
        print(f"[scan] {line}")
    seconds = time.perf_counter() - t_phase
    print(f"[scan] phase 20: {seconds:.1f} s")
    return {"cases": cases, "kernel_vs_plain": timed,
            "pointer_chase_ns": {"shared": shared_ns, "l2": l2_ns},
            "launches": sum(r["launches"] for r in cases),
            "node_report": {"t_est": rep.node.t_est,
                            "t_zero_contention": rep.node.t_zero_contention,
                            "iterations": rep.node.iterations,
                            "seconds": t_report},
            "seconds": seconds}


# phases 25-27: sampled estimation, the model zoo, the calibration CLIs
SAMPLE_CORE_COUNTS = (1, 12, 48)   # the zoo's core axis, A64FX_NODE
SAMPLE_NUMPY_CAPTURE = "mamba2-1.3b training step"   # held against NumPy
ZOO_TAU_FLOOR = 0.5                # tests/test_zoo.py's rank floor
ZOO_NUMPY_CELL = ("zamba2-1.2b", "train")            # held against NumPy


class ScanCount:
    """The scan kernel's launches, batch elements and device time (CUDA
    events around each launch) over a ``with`` block; counts set to 0 on
    entry."""

    def __enter__(self):
        from repro_torch.kernels import sched_scan
        self.scan = sched_scan.node_scan
        self.scan.launches = self.scan.elements = 0
        self.scan.events = []
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        events, self.scan.events = self.scan.events, None
        self.launches = self.scan.launches
        self.elements = self.scan.elements
        self.batch = sorted({m for m, _, _ in events})
        self.ms = sum(a.elapsed_time(b) for _, a, b in events)
        return False

    def row(self) -> dict:
        return {"launches": self.launches, "elements": self.elements,
                "batch_sizes": [self.batch[0], self.batch[-1]]
                if self.batch else [], "kernel_ms": self.ms}


def sampled_estimation(dev, captures) -> dict:
    """Phase 25, sampled estimation at full width: each kernel-path capture
    of phase 19 (the two training steps, the five prefills) is costed once
    against ``A64FX_CORE``, sampled (``SamplingConfig()``: 512-instance
    intervals, k by the BIC elbow, seed 0), and swept over the zoo's
    12-combo O3 grid at 1/12/48 cores on ``A64FX_NODE`` twice through the
    scan kernel: sampled (``sampled_node_sweep``) and in full
    (``schedule_node_sweep``).  Printed: the error of the sampled grid
    against the full one, the share of op instances scheduled, the wall
    seconds of each and the scan's launches and device time.  At 12 cores
    ``full_interval_estimate`` and the sampled estimate at k >= n_intervals
    must give the same bits, and one capture's sampled sweep must equal
    ``backend="numpy"``'s."""
    import numpy as np

    from repro_torch.core import cost, node, sample, zoo
    from repro_torch.core.hwspec import A64FX_CORE, A64FX_NODE

    t_phase = time.perf_counter()
    hw, dt, cfg = A64FX_CORE, "bf16", sample.SamplingConfig()
    knobs = zoo.zoo_o3_knobs(hw)
    rows = []
    for label, prog in captures:
        if "kernel path" not in label:
            continue
        costed = cost.cost_program(prog, hw, compute_dtype=dt)
        t0 = time.perf_counter()
        plan = sample.sample_program(prog, hw, cfg, dt, costed)
        plan_s = time.perf_counter() - t0
        kw = dict(topology=A64FX_NODE, compute_dtype=dt)
        with ScanCount() as sampled_scan:
            t0 = time.perf_counter()
            got, _ = sample.sampled_node_sweep(
                prog, hw, knobs, SAMPLE_CORE_COUNTS, plan=plan,
                backend="torch", device=dev, **kw)
            sampled_s = time.perf_counter() - t0
        nc = node.compile_node(prog, hw, compute_dtype=dt, costed=costed)
        with ScanCount() as full_scan:
            t0 = time.perf_counter()
            full = node.schedule_node_sweep(
                nc, hw, knobs, SAMPLE_CORE_COUNTS, A64FX_NODE,
                backend="torch", device=dev)
            full_s = time.perf_counter() - t0
        if not (np.isfinite(got).all() and got.shape == full.shape):
            fail(f"{label}: sampled grid {got.shape} not finite")
        err = 100.0 * (got - full) / full
        exact = sample.full_interval_estimate(prog, hw, 12, A64FX_NODE,
                                              "shard", cfg, dt, costed)
        at_n = sample.sampled_schedule_node(
            prog, hw, 12, A64FX_NODE, "shard",
            dataclasses.replace(cfg, k=10 ** 9), dt, costed)
        if at_n.t_est != exact.t_est or exact.plan.k != plan.n_intervals:
            fail(f"{label}: k >= n_intervals gives {at_n.t_est!r}, full "
                 f"interval scheduling {exact.t_est!r}")
        row = {"capture": label, "n_ops": len(prog.ops),
               "n_intervals": plan.n_intervals, "k": plan.k,
               "frac_ops_scheduled": plan.frac_ops_scheduled,
               "max_abs_err_pct": float(np.abs(err).max()),
               "median_abs_err_pct": float(np.median(np.abs(err))),
               "err_pct_at_cores": {str(c): float(np.abs(err[i]).max())
                                    for i, c in enumerate(SAMPLE_CORE_COUNTS)},
               "t_full_12c_best_us": float(full[1].min() * 1e6),
               "t_sampled_12c_best_us": float(got[1].min() * 1e6),
               "plan_s": plan_s, "sampled_s": sampled_s, "full_s": full_s,
               "scan_sampled": sampled_scan.row(),
               "scan_full": full_scan.row(),
               "full_interval_bits_equal": True}
        if label.startswith(SAMPLE_NUMPY_CAPTURE):
            want, _ = sample.sampled_node_sweep(
                prog, hw, knobs, SAMPLE_CORE_COUNTS, plan=plan, **kw)
            differ = int(np.count_nonzero(got.view(np.int64)
                                          != want.view(np.int64)))
            if differ:
                fail(f"{label}: the sampled sweep on the card differs from "
                     f"NumPy's in {differ} of {want.size} elements")
            row["numpy_elements_differing"] = differ
        print(f"[sample] {label}: {row['n_ops']} ops, k {plan.k} of "
              f"{plan.n_intervals} intervals, "
              f"{plan.frac_ops_scheduled:.1%} of instances scheduled; "
              f"sampled vs full grid ({knobs.batch} combos x "
              f"{len(SAMPLE_CORE_COUNTS)} core counts) |err| max "
              f"{row['max_abs_err_pct']:.3f} %, median "
              f"{row['median_abs_err_pct']:.3f} %; wall sampled "
              f"{sampled_s:.3f} s ({sampled_scan.launches} launches, "
              f"{sampled_scan.ms:.2f} ms of kernel time) vs full "
              f"{full_s:.3f} s ({full_scan.launches} launches, "
              f"{full_scan.ms:.2f} ms), plan {plan_s:.3f} s; "
              f"full_interval_estimate == sampled at k >= n: bit-identical"
              + ("; sampled sweep == numpy: 0 elements differ"
                 if "numpy_elements_differing" in row else ""))
        rows.append(row)
    if len(rows) != 7 or not all(r["scan_sampled"]["launches"]
                                 and r["scan_full"]["launches"] for r in rows):
        fail(f"phase 25 ran {len(rows)} captures, or without the scan kernel")
    seconds = time.perf_counter() - t_phase
    print(f"[sample] phase 25: {seconds:.1f} s")
    return {"rows": rows, "seconds": seconds,
            "launches": sum(r["scan_sampled"]["launches"]
                            + r["scan_full"]["launches"] for r in rows)}


def model_zoo(dev) -> dict:
    """Phase 26, the model zoo: ``zoo.run_zoo`` over all ten architectures
    and their phases (captured at reduced width over fake CPU tensors),
    the 12-combo O3 grid of each cell at 1/12/48 cores on the scan kernel
    (``backend="torch"``); one cell held bit for bit against
    ``backend="numpy"``; the wall seconds per cell and in all, the Kendall
    taus across core counts (at least the reference's floor of 0.5) and
    against the ranks of the reference's ``BENCH_model_zoo.json``."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import zoo
    from repro_torch.core.hwspec import A64FX_CORE
    sys.path.insert(0, str(ROOT / "tools"))
    from model_zoo_torch import taus_against

    cells = {}

    def progress(arch, phase, pe, wall):
        cells[f"{arch}/{phase}"] = {"n_ops": pe.n_ops, "wall_s": wall}
        print(f"[zoo] {arch} {phase}: {pe.n_ops} ops, t_est "
              + ", ".join(f"{ce.n_cores}c {ce.t_est_s * 1e6:.1f} us"
                          for ce in pe.per_core)
              + f", best of the O3 grid at 12c "
              f"{pe.at(12).t_best_knobs_s * 1e6:.1f} us; {wall:.2f} s")

    zoo.clear_trace_caches()
    with ScanCount() as scan:
        report = zoo.run_zoo(progress=progress, backend="torch", device=dev)
    d = report.to_dict()
    if sorted(d["models"]) != sorted(ARCHS) or len(cells) != 30:
        fail(f"the zoo covered {len(d['models'])} architectures, "
             f"{len(cells)} cells")
    arch, phase = ZOO_NUMPY_CELL
    t0 = time.perf_counter()
    pe = zoo.estimate_program(
        zoo.trace_phase(arch, phase), A64FX_CORE,
        model_flops=zoo.phase_model_flops(zoo.zoo_config(arch),
                                          zoo.ZOO_SHAPES[phase]),
        o3_knobs=zoo.zoo_o3_knobs(A64FX_CORE), arch=arch, phase=phase)
    numpy_s = time.perf_counter() - t0
    if dataclasses.asdict(pe) != dataclasses.asdict(
            report.estimates[arch][phase]):
        fail(f"zoo cell {arch}/{phase}: the scan kernel's estimate differs "
             f"from backend='numpy'")
    ref = json.loads((ROOT / "BENCH_model_zoo.json").read_text())
    vs_ref = taus_against(ref, d)
    for ph in report.phases:
        taus = d["kendall_tau"][ph]
        print(f"[zoo] {ph}: Kendall tau across core counts "
              + ", ".join(f"{k} {v:+.3f}" for k, v in taus.items())
              + "; against BENCH_model_zoo.json's ranks "
              + ", ".join(f"@{k}c {v:+.3f}" for k, v in vs_ref[ph].items()))
        if taus["min"] < ZOO_TAU_FLOOR:
            fail(f"zoo {ph}: rank tau {taus['min']:.3f} under the "
                 f"{ZOO_TAU_FLOOR} floor")
    if not scan.launches:
        fail("the zoo's O3 grid did not launch the scan kernel")
    print(f"[zoo] phase 26: {len(cells)} cells in {report.wall_s:.1f} s, the "
          f"scan kernel {scan.launches} launches ({scan.elements} elements, "
          f"batches of {scan.batch[0]}-{scan.batch[-1]}) and {scan.ms:.1f} "
          f"ms of kernel time; {arch}/{phase} on backend='numpy' in "
          f"{numpy_s:.2f} s: the same estimate, bit for bit")
    return {"wall_s": report.wall_s, "cells": cells, "scan": scan.row(),
            "launches": scan.launches, "kendall_tau": d["kendall_tau"],
            "vs_reference": vs_ref, "rank": d["rank"],
            "numpy_cell": {"cell": f"{arch}/{phase}", "bits_equal": True,
                           "numpy_s": numpy_s}}


def calibration_clis() -> dict:
    """Phase 27, the calibration CLIs on the card through ``tools/run_torch.py
    --quick``: ``kernel_suite_torch`` (``fit_h100``, the Fig. 3 table
    through K1) and ``triad_torch`` (K2 at 4 CTA caps), each writing its
    JSON into a temporary directory, K1's and K2's launches counted from 0,
    the JSON held to its schema and the CSV to one row a kernel, two of
    the summary and one a Triad CTA cap."""
    import tempfile

    from repro_torch.kernels import stream
    sys.path.insert(0, str(ROOT / "tools"))
    import run_torch

    t_phase = time.perf_counter()
    stream.elementwise.launches = stream.stream_triad.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        ks, tr = Path(tmp) / "kernel_suite.json", Path(tmp) / "triad.json"
        if run_torch.main(["--quick", "--out-dir", tmp]):
            fail("a calibration CLI exited non-zero")
        suite, triad = json.loads(ks.read_text()), json.loads(tr.read_text())
        csv = run_torch.csv_rows(Path(tmp))
    launches = {"stream_elementwise": stream.elementwise.launches,
                "stream_triad": stream.stream_triad.launches}
    want = {"kernels", "scheduler_throughput", "summary", "calibrated",
            "card", "device"}
    if not want <= set(suite) or len(suite["kernels"]) != 7 \
            or not {"calibration", "triad_l2", "triad_mem"} <= set(triad):
        fail(f"the CLIs' JSON misses keys: {sorted(suite)}, {sorted(triad)}")
    if not all(launches.values()):
        fail(f"the calibration CLIs launched {launches}")
    if len(csv) != len(suite["kernels"]) + 2 + len(triad["triad_l2"]) \
            + len(triad["triad_mem"]):
        fail(f"run_torch's CSV has {len(csv)} rows")
    seconds = time.perf_counter() - t_phase
    print(f"[cli] phase 27: tools/run_torch.py --quick (kernel_suite_torch "
          f"and triad_torch) in {seconds:.1f} s; launches {launches}; "
          f"{len(csv)} CSV rows; Fig. 3 mean|.| "
          f"{suite['summary']['mean_abs_diff_pct']:.1f} % over "
          f"{len(suite['kernels'])} kernels; Triad plateau "
          f"{triad['calibration']['mem']['plateau'] / 1e9:.1f} GB/s")
    return {"launches": launches, "seconds": seconds,
            "summary": suite["summary"], "triad": triad["calibration"]}


@contextlib.contextmanager
def recording_shapes(shapes):
    """While in the context, every launch of K3, K4 and K5 adds its shape,
    dtype and B/C layout (the arguments of ``compare``, ``compare_ssd`` and
    ``compare_ssd_bwd``) to ``shapes[kernel]``, so that the kernel can be
    held there against its plain version afterwards."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    def dtype_name(t):
        return str(t.dtype).removeprefix("torch.")

    def flash_at(q, k, v, out, causal):   # compare()'s arguments
        B, H, Sq, D = q.shape
        return (B, Sq, k.shape[2], H, k.shape[1], D, bool(causal),
                dtype_name(q), q.stride(1) < q.stride(2))

    def ssd_at(x, dt, A, Bm, Cm, *outputs):   # compare_ssd()'s arguments
        B, nc, Q, H, P = x.shape
        return (B, nc * Q, H, P, Bm.shape[-1], Q, dtype_name(x),
                Bm.stride(3) == 0)

    def recording(name, launch, signature):
        def launch_and_record(*args):
            shapes[name].add(signature(*args))
            return launch(*args)
        return launch_and_record

    launchers = [(fa, "_launch", "flash_attention", flash_at),
                 (ssd, "_launch", "ssd_scan", ssd_at),
                 (ssd, "_launch_bwd", "ssd_scan_bwd", ssd_at)]
    originals = [getattr(mod, attr) for mod, attr, _, _ in launchers]
    try:
        for (mod, attr, name, signature), launch in zip(launchers,
                                                        originals):
            setattr(mod, attr, recording(name, launch, signature))
        yield shapes
    finally:
        for (mod, attr, _, _), launch in zip(launchers, originals):
            setattr(mod, attr, launch)


# phases 28-29: hardware DSE and the serving simulator
def run_tool(script: str, *args: str) -> subprocess.CompletedProcess:
    """``tools/<script>`` in a process of its own with ``src`` on its path;
    fails the run on a non-zero exit, with the end of its output."""
    import os
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / script), *args],
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if proc.returncode:
        fail(f"{script} {' '.join(args)} exited {proc.returncode}: "
             f"{(proc.stdout + proc.stderr)[-2000:]}")
    return proc


def dse_on_card(dev, captures) -> dict:
    """Phase 28, hardware DSE on the card (``core.dse``): (a) each
    kernel-path capture of phase 19 (the two training steps, the five
    prefills) swept over the 64-candidate grid (``spec_grid(
    generate_grid())``: 8-72 cores, 1-6 CMGs, ring 0 or 130 ns) with
    ``backend="torch"``, the grid's compile on the host timed apart from
    the sweep, the scan's launches, elements and device time counted
    around it, the best candidate and the Pareto front over (cycles, HBM
    bytes, cores), and the Kendall tau of the candidates' ranks across
    the seven; (b) mamba2-1.3b's step swept again on NumPy: 0 of 64
    elements may differ; (c) ``run_dse`` on the reference bench's ten zoo
    workloads on the scan, its rank stability and the tau of each
    workload's ranks against ``BENCH_dse.json``'s; (d)
    ``tools/dse_sweep_torch.py --quick`` in a process of its own, whose
    exit code carries its gates: the fused sweep on the scan
    bit-identical to the per-spec loop and above its 10x floor."""
    import tempfile

    import numpy as np

    from repro_torch.core import dse, zoo
    from repro_torch.core.node import compile_node_grid
    sys.path.insert(0, str(ROOT / "tools"))
    from dse_sweep_torch import (FULL_MODELS, FULL_PHASES, REFERENCE_JSON,
                                 against_reference)

    t_phase = time.perf_counter()
    points = dse.generate_grid()
    grid = dse.spec_grid(points)
    rows, t_cols = [], []
    for label, prog in captures:
        if "kernel path" not in label:
            continue
        t0 = time.perf_counter()
        compile_node_grid(prog, grid, compute_dtype="f32")
        compile_s = time.perf_counter() - t0
        with ScanCount() as scan:
            t0 = time.perf_counter()
            sw = dse.sweep_workload(prog, grid, backend="torch", device=dev)
            sweep_s = time.perf_counter() - t0
        t = sw["t_est"]
        if t.shape != (grid.S,) or not (np.isfinite(t).all()
                                        and (t > 0).all()):
            fail(f"{label}: DSE estimates {t.shape} not finite and positive")
        front = dse.pareto_front(np.stack(
            [t * zoo.DEFAULT_CLOCK_HZ, sw["hbm_bytes"], sw["n_cores"]], 1))
        best = int(np.argmin(t))
        row = {"capture": label, "n_ops": len(prog.ops),
               "compile_s": compile_s, "sweep_s": sweep_s,
               "scan": scan.row(), "best_spec": points[best].name,
               "t_best_us": float(t[best] * 1e6),
               "t_a64fx_us": float(t[points.index(
                   dse.SpecPoint(4, 12, 1, 130.0, 2))] * 1e6),
               "pareto_size": len(front),
               "pareto_specs": [points[i].name for i in front]}
        if label.startswith(SCAN_STEP):
            t0 = time.perf_counter()
            want = dse.sweep_workload(prog, grid, backend="numpy")["t_est"]
            row["numpy_sweep_s"] = time.perf_counter() - t0
            differ = int(np.count_nonzero(t.view(np.int64)
                                          != want.view(np.int64)))
            if differ:
                fail(f"{label}: the DSE sweep on the card differs from "
                     f"NumPy's in {differ} of {want.size} elements")
            row["numpy_elements_differing"] = differ
        print(f"[dse] {label}: {row['n_ops']} ops x {grid.S} candidates; "
              f"grid compile {compile_s:.2f} s (host), sweep {sweep_s:.3f} s "
              f"({scan.launches} launches, {scan.elements} elements, "
              f"{scan.ms:.2f} ms of kernel time); best {row['best_spec']} "
              f"{row['t_best_us']:.1f} us (A64FX {row['t_a64fx_us']:.1f} us), "
              f"Pareto front of {len(front)}"
              + (f"; numpy sweep {row['numpy_sweep_s']:.3f} s, 0 of "
                 f"{grid.S} elements differ"
                 if "numpy_elements_differing" in row else ""))
        rows.append(row)
        t_cols.append(t)
    if len(rows) != 7 or not all(r["scan"]["launches"] for r in rows):
        fail(f"phase 28 swept {len(rows)} captures, or without the scan "
             f"kernel")
    taus = [zoo.kendall_tau(list(t_cols[i]), list(t_cols[j]))
            for i in range(len(t_cols)) for j in range(i + 1, len(t_cols))]
    print(f"[dse] the candidates' ranks across the 7 captures: Kendall tau "
          f"min {min(taus):+.3f}, mean {np.mean(taus):+.3f}")

    workloads = zoo.zoo_workloads(FULL_MODELS, FULL_PHASES)
    with ScanCount() as zscan:
        t0 = time.perf_counter()
        payload = dse.run_dse(workloads, points=points, backend="torch",
                              device=dev)
        run_dse_s = time.perf_counter() - t0
    if not zscan.launches or len(payload["per_workload"]) != 10:
        fail(f"run_dse swept {len(payload['per_workload'])} workloads with "
             f"{zscan.launches} scan launches")
    vs_ref = against_reference(json.loads(REFERENCE_JSON.read_text()),
                               payload)
    for key, v in vs_ref.items():
        print(f"[dse] run_dse {key}: {v['n_ops']} ops (reference "
              f"{v['reference_n_ops']}), best {v['best_spec']} (reference "
              f"{v['reference_best_spec']}), Kendall tau against "
              f"BENCH_dse.json's ranks {v['kendall_tau']:+.3f}")
    rs = payload["rank_stability"]
    print(f"[dse] run_dse: {len(workloads)} zoo workloads in {run_dse_s:.1f} "
          f"s, the scan {zscan.launches} launches ({zscan.ms:.1f} ms); rank "
          f"stability mean tau {rs['mean_tau']:+.3f}, min {rs['min_tau']:+.3f}")

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dse_quick.json"
        t0 = time.perf_counter()
        run_tool("dse_sweep_torch.py", "--quick", "--backend", "torch",
                 "--out", str(out))
        cli_s = time.perf_counter() - t0
        quick = json.loads(out.read_text())
    thr = quick["throughput"]
    print(f"[dse] dse_sweep_torch --quick ({quick['n_ops']} ops, "
          f"{quick['n_specs']} specs, scan on {quick['device']}): fused "
          f"{thr['fused_wall_s'] * 1e3:.1f} ms vs per-spec loop "
          f"{thr['loop_wall_s'] * 1e3:.1f} ms, {thr['speedup']:.1f}x "
          f"(floor {quick['floor_speedup']:.0f}x), bit-identical; "
          f"{cli_s:.1f} s")
    seconds = time.perf_counter() - t_phase
    print(f"[dse] phase 28: {seconds:.1f} s")
    return {"rows": rows, "taus_across_captures": {
                "min": min(taus), "mean": float(np.mean(taus))},
            "run_dse": {"seconds": run_dse_s, "scan": zscan.row(),
                        "rank_stability": rs, "vs_reference": vs_ref},
            "quick": {"throughput": thr, "seconds": cli_s},
            "launches": sum(r["scan"]["launches"] for r in rows)
            + zscan.launches, "seconds": seconds}


def serving_on_card(dev, check_kernels) -> dict:
    """Phase 29, the serving simulator and ``serve_lm``: (a)
    ``tools/serving_sweep_torch.py --quick`` in a process of its own,
    whose exit code carries its three gates (wall budget, b=8 at least
    1.5x b=1 tokens/s, Little's-law gap under 1e-6); (b)
    ``build_zoo_cost_model`` for the four full models from the port's
    captures and the six-policy sweep at 600 requests each (the CLI's full
    mode): Pareto fronts, best policy, prefill us/token, the decode grid
    and KV bytes a token, which must equal ``BENCH_serving.json``'s; every
    time there is an A64FX-node estimate of the model, not a card time;
    (c) ``examples/serve_lm_torch.py`` on the card for each of its two
    models, K3, K4 and K5 counted from 0 around each: rule-following
    accuracy above 0.5, K3 launched by chatglm3-6b's serving, K4 and K5 by
    mamba2-1.3b's training and K4 by its serving; every shape, dtype and
    B/C layout the example launched a kernel at is recorded and handed to
    ``check_kernels``, which holds the kernel there against its plain
    version (after the counts are read: those launches do not count)."""
    import importlib.util
    import tempfile

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    sys.path.insert(0, str(ROOT / "tools"))
    import serving_sweep_torch as sst

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "serving_quick.json"
        run_tool("serving_sweep_torch.py", "--quick", "--out", str(out))
        quick = json.loads(out.read_text())
    gains = {mix: row["policies"]["fcfs_b8"]["tokens_per_s"]
             / row["policies"]["fcfs_b1"]["tokens_per_s"]
             for mix, row in quick["models"].items()}
    print(f"[serving] serving_sweep_torch --quick: {quick['wall_s']:.2f} s; "
          f"b8/b1 tokens/s " + ", ".join(f"{m} {g:.2f}x"
                                         for m, g in gains.items())
          + f" (gate {sst.QUICK_BATCH_GAIN}x); Little's-law gap < 1e-6")

    with tempfile.TemporaryDirectory() as tmp:
        full = sst.run_full(sst.FULL_MODELS, sst.N_REQUESTS,
                            Path(tmp) / "programs", Path(tmp) / "cost")
    vs_ref = sst.against_reference(
        json.loads(sst.REFERENCE_JSON.read_text()), full)
    for arch, row in full["models"].items():
        v = vs_ref[arch]
        best = row["policies"][v["best_policy"]]
        print(f"[serving] {arch} (A64FX-node estimates of the model, not "
              f"card times): prefill {row['prefill_us_per_token']:.3f} "
              f"us/token (reference {v['reference_prefill_us_per_token']:.3f})"
              f", decode grid " + ", ".join(f"b{b} {t:.1f} us" for b, t in
                                           row["decode_grid_us"])
              + f"; KV {row['bytes_per_token']:.0f} B/token; best "
              f"{v['best_policy']} {best['tokens_per_s']:.1f} tok/s, p99 "
              f"TTFT {best['p99_ttft_ms']:.1f} ms (reference best "
              f"{v['reference_best_policy']}); Pareto "
              f"{', '.join(v['pareto'])} (reference "
              f"{', '.join(v['reference_pareto'])}); {row['wall_s']:.1f} s")
        if v["bytes_per_token"] != v["reference_bytes_per_token"]:
            fail(f"{arch}: {v['bytes_per_token']} KV bytes a token, the "
                 f"reference {v['reference_bytes_per_token']}")

    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", ROOT / "examples" / "serve_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    shapes = {name: set() for name in KERNELS}
    served = {}
    with recording_shapes(shapes):
        for arch in example.ARCHS_SERVED:
            fa.flash_attention_bhsd.launches = ssd.ssd_chunk.launches = 0
            ssd.ssd_chunk_bwd.launches = 0
            t0 = time.perf_counter()
            served[arch] = r = example.serve_arch(arch, device=dev)
            torch.cuda.synchronize()
            r["seconds"] = time.perf_counter() - t0
            r["launches"] = {
                "flash_attention": fa.flash_attention_bhsd.launches,
                "ssd_scan": ssd.ssd_chunk.launches,
                "ssd_scan_bwd": ssd.ssd_chunk_bwd.launches}
    for arch, r in served.items():
        print(f"[serve_lm] {arch}: rule-following accuracy {r['hits']}/"
              f"{r['total']}, launches {r['launches']}, {r['seconds']:.1f} s")
        if r["accuracy"] <= 0.5:
            fail(f"serve_lm {arch}: accuracy {r['accuracy']:.3f}")
    k = {a: r["launches"] for a, r in served.items()}
    if not (k["chatglm3-6b"]["flash_attention"]
            and k["mamba2-1.3b"]["ssd_scan"]
            and k["mamba2-1.3b"]["ssd_scan_bwd"]):
        fail(f"serve_lm launched {k}")
    print("[serve_lm] the kernels at the example's shapes: " + "; ".join(
        f"{name} {sorted(at)}" for name, at in shapes.items()))
    checks = check_kernels(shapes)
    seconds = time.perf_counter() - t_phase
    print(f"[serving] phase 29: {seconds:.1f} s")
    return {"quick": {"wall_s": quick["wall_s"], "b8_over_b1": gains},
            "full": full, "vs_reference": vs_ref, "serve_lm": served,
            "kernel_checks": checks,
            "launches": {name: sum(r["launches"][name]
                                   for r in served.values())
                         for name in KERNELS}, "seconds": seconds}


# phase 30: meshes (parallel/), the elastic restore, the cluster CLI
MESH_TRAIN_BATCH, MESH_TRAIN_STEPS = 4, 3
MESH_RESTORE_LAYERS = 8
MESH_PROMPT_LENS, MESH_NEW_TOKENS = (128, 2048), 16
MESH_LOSS_RTOL = 1e-6


def meshes_on_card(dev, check_kernels) -> dict:
    """Phase 30, the port's mesh path on a one-device mesh: (a)
    ``launch.train.train_loop`` trains mamba2-1.3b at full width and depth
    (48 layers) for 3 steps of 4 x 2048 tokens without a mesh and on a 1x1 ("data", "model")
    ``DeviceMesh`` (a one-rank NCCL group; every parameter, optimizer leaf
    and batch a replicated DTensor), from the same seed and batches: the
    losses within 1e-6 relative (equal bits expected: one rank runs the
    same ops on the same tensors), K4 and K5 launched as often, the step's
    host ms side by side; (c) the state of mamba2-1.3b at
    ``MESH_RESTORE_LAYERS`` (8) layers after one step without a mesh
    written by ``AsyncCheckpointer``, restored through
    ``restore(shardings=)`` onto the mesh bit for bit (the free space where
    it is written printed beside its size), and one more step there with a
    finite loss (the 48 layers' 12.5 GiB state took ~75 s more, which the
    script's time limit no longer holds); (b)
    chatglm3-6b at full width served through ``ServeEngine`` and
    ``ServeEngine(rules=)`` on the same mesh, 2 requests of 128 and 2048
    tokens and 16 new tokens: the same greedy tokens, K3 launched 28 times
    a request by each; every shape K3, K4 and K5 launched at is held
    against its plain version (``check_kernels``); the group is destroyed
    at the end; (d) ``tools/cluster_scaling_torch.py --quick`` (its numbers
    must equal the reference's ``--quick``, or it exits 1) and its full
    run on the host, ranks and plan taus against ``BENCH_cluster.json``."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, RunConfig, ShapeConfig
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import (build_training, host_float,
                                          place_batch, train_loop)
    from repro_torch.models import params as pr
    from repro_torch.models.lm import build_model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import checkpoint as ck

    def reset():
        fa.flash_attention_bhsd.launches = ssd.ssd_chunk.launches = 0
        ssd.ssd_chunk_bwd.launches = 0

    def counts():
        return {"flash_attention": fa.flash_attention_bhsd.launches,
                "ssd_scan": ssd.ssd_chunk.launches,
                "ssd_scan_bwd": ssd.ssd_chunk_bwd.launches}

    t_phase = time.perf_counter()
    shapes = {name: set() for name in KERNELS}
    launches = {name: 0 for name in KERNELS}
    out = {}
    mesh = make_host_mesh(1, 1)            # a one-rank NCCL group
    try:
        with recording_shapes(shapes):
            # (a) training, no mesh and 1x1 -------------------------------
            cfg = ARCHS[SSM_ARCH]
            run = RunConfig(model=cfg, shape=ShapeConfig(
                "mesh", TRAIN_SEQ, MESH_TRAIN_BATCH, "train"))
            model = build_model(cfg, ssd_impl="kernel")
            runs = {}
            for name, m in (("no mesh", None), ("mesh 1x1", mesh)):
                gc.collect()
                torch.cuda.empty_cache()
                reset()
                rep = train_loop(model, run, n_steps=MESH_TRAIN_STEPS,
                                 seed=0, log_every=MESH_TRAIN_STEPS,
                                 device=dev, mesh=m)
                torch.cuda.synchronize()
                runs[name] = (rep, counts())
                for k, v in runs[name][1].items():
                    launches[k] += v
            (plain, k_plain), (meshed, k_mesh) = runs.values()
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(meshed.losses, plain.losses))
            same_bits = meshed.losses == plain.losses
            host = {n: [t * 1e3 for t in r.step_times]
                    for n, (r, _) in runs.items()}
            steady = {n: float(np.median(v[1:])) for n, v in host.items()}
            print(f"[mesh] {SSM_ARCH} ({cfg.n_layers} layers) training, "
                  f"losses no mesh {plain.losses}, 1x1 {meshed.losses}: "
                  f"equal bits {same_bits}, max rel {rel:.3e}; launches "
                  f"{k_plain} and {k_mesh}; step host ms no mesh "
                  + ", ".join(f"{t:.1f}" for t in host["no mesh"])
                  + "; 1x1 " + ", ".join(f"{t:.1f}" for t in host["mesh 1x1"])
                  + f" (median after the first {steady['no mesh']:.1f} "
                  f"against {steady['mesh 1x1']:.1f} ms, "
                  f"{steady['mesh 1x1'] / steady['no mesh']:.3f}x)")
            want = {"flash_attention": 0,
                    "ssd_scan": 2 * cfg.n_layers * MESH_TRAIN_STEPS,
                    "ssd_scan_bwd": cfg.n_layers * MESH_TRAIN_STEPS}
            if k_plain != want or k_mesh != want:
                fail(f"mesh training launches {k_plain}, {k_mesh}; want "
                     f"{want}")
            if not (rel <= MESH_LOSS_RTOL and all(np.isfinite(meshed.losses))):
                fail(f"mesh training losses {meshed.losses} against "
                     f"{plain.losses}")
            out["training"] = {
                "arch": SSM_ARCH, "layers": cfg.n_layers,
                "batch": MESH_TRAIN_BATCH, "seq": TRAIN_SEQ,
                "losses_no_mesh": plain.losses,
                "losses_mesh": meshed.losses, "equal_bits": same_bits,
                "max_rel_loss_diff": rel, "step_host_ms": host,
                "median_step_host_ms": steady,
                "launches_no_mesh": k_plain, "launches_mesh": k_mesh}

            # (c) the elastic restore of a no-mesh state onto the mesh, at
            # MESH_RESTORE_LAYERS layers: 2.9 GiB where the 48 layers'
            # 12.5 GiB took ~75 s to snapshot, write and read back
            del runs, meshed, plain
            gc.collect()
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(cfg, n_layers=MESH_RESTORE_LAYERS)
            run = dataclasses.replace(run, model=cfg)
            model = build_model(cfg, ssd_impl="kernel")
            state = train_loop(model, run, n_steps=1, seed=0, log_every=1,
                               device=dev).state
            with tempfile.TemporaryDirectory() as tmp:
                free = shutil.disk_usage(tmp).free
                t0 = time.perf_counter()
                saver = ck.AsyncCheckpointer()
                saver.save(tmp, MESH_TRAIN_STEPS, state,
                           extra={"seed": 0})
                t_save = time.perf_counter() - t0
                saver.wait()
                t_write = time.perf_counter() - t0
                step_fn, _, (p_sh, o_sh) = build_training(model, run, dev,
                                                          mesh)
                t0 = time.perf_counter()
                at, restored, extra = ck.restore(
                    tmp, state, shardings=(p_sh, o_sh), mesh=mesh)
                t_restore = time.perf_counter() - t0
            exact = all(torch.equal(a.to_local(), b) for a, b in zip(
                ck.flatten(restored), ck.flatten(state)))
            batch = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ,
                                       MESH_TRAIN_BATCH, seed=0).batch(
                MESH_TRAIN_STEPS)["tokens"]
            batch = place_batch(model, run, {"tokens": torch.from_numpy(
                batch).to(dev, torch.long)}, mesh)
            reset()
            _, _, metrics = step_fn(*restored, batch)
            loss = host_float(metrics["loss"])
            k_restore = counts()
            for k, v in k_restore.items():
                launches[k] += v
            n_bytes = sum(t.numel() * t.element_size()
                          for t in ck.flatten(state))
            print(f"[mesh] elastic restore: {n_bytes / 2**30:.2f} GiB of "
                  f"state at step {at} (extra {extra}; {free / 2**30:.1f} "
                  f"GiB free where it was written); snapshot "
                  f"{t_save:.2f} s, written {t_write:.2f} s, restored onto "
                  f"the mesh {t_restore:.2f} s; bit for bit {exact}; the "
                  f"next step's loss {loss:.4f}; launches {k_restore}")
            if not (exact and at == MESH_TRAIN_STEPS and np.isfinite(loss)
                    and extra == {"seed": 0}):
                fail(f"elastic restore: exact {exact}, step {at}, loss "
                     f"{loss}, extra {extra}")
            out["elastic_restore"] = {
                "state_bytes": n_bytes, "free_bytes": free,
                "snapshot_s": t_save,
                "write_s": t_write, "restore_s": t_restore,
                "bit_for_bit": exact, "next_loss": loss,
                "launches": k_restore}
            del state, restored, step_fn, model, batch
            gc.collect()
            torch.cuda.empty_cache()

            # (b) serving on the mesh ---------------------------------------
            cfg = ARCHS[ARCH]
            model = build_model(cfg, attn_impl="flash")
            params = model.init(torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.bfloat16)
            rng = np.random.default_rng(0)
            prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                       for n in MESH_PROMPT_LENS]
            max_seq = max(MESH_PROMPT_LENS) + MESH_NEW_TOKENS
            served = {}
            for name, rules in (("no mesh", None),
                                ("mesh 1x1", make_rules(mesh))):
                engine = ServeEngine(model, params, max_seq=max_seq,
                                     device=dev, rules=rules)
                engine.generate([prompts[0][:16]], max_new_tokens=2)
                torch.cuda.synchronize()
                reset()
                toks = engine.generate(prompts,
                                       max_new_tokens=MESH_NEW_TOKENS)
                torch.cuda.synchronize()
                served[name] = (toks, counts(), engine.timings)
                for k, v in served[name][1].items():
                    launches[k] += v
                del engine
            (t_plain, k_plain, tm_plain), (t_mesh, k_mesh, tm_mesh) = \
                served.values()
            want = {"flash_attention": cfg.n_layers * len(prompts),
                    "ssd_scan": 0, "ssd_scan_bwd": 0}
            timing = {n: [{"prompt": t.prompt_len,
                           "prefill_ms": t.prefill_s * 1e3,
                           "decode_ms_per_token":
                           t.decode_s * 1e3 / t.decode_steps}
                          for t in tm] for n, (_, _, tm) in served.items()}
            print(f"[mesh] {ARCH} served without and with the 1x1 mesh: "
                  f"same tokens {t_plain == t_mesh}; launches {k_plain} "
                  f"and {k_mesh} (want {want}); " + "; ".join(
                      f"{n}: " + ", ".join(
                          f"prompt {r['prompt']} prefill "
                          f"{r['prefill_ms']:.1f} ms, decode "
                          f"{r['decode_ms_per_token']:.1f} ms/token"
                          for r in rows) for n, rows in timing.items()))
            if t_plain != t_mesh or k_plain != want or k_mesh != want:
                fail(f"mesh serving: tokens {t_mesh} against {t_plain}, "
                     f"launches {k_plain}, {k_mesh}")
            out["serving"] = {"arch": ARCH, "prompt_tokens":
                              list(MESH_PROMPT_LENS),
                              "new_tokens": MESH_NEW_TOKENS,
                              "same_tokens": t_plain == t_mesh,
                              "launches_no_mesh": k_plain,
                              "launches_mesh": k_mesh, "timing": timing}
            del model, params, served
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print("[mesh] the kernels at phase 30's shapes: " + "; ".join(
        f"{name} {sorted(at)}" for name, at in shapes.items()))
    out["kernel_checks"] = check_kernels(shapes)
    out["launches"] = launches

    # (d) the cluster CLI, on the host ----------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        quick_path, full_path = Path(tmp) / "quick.json", Path(tmp) / "full.json"
        run_tool("cluster_scaling_torch.py", "--quick", "--out",
                 str(quick_path))
        quick = json.loads(quick_path.read_text())
        t0 = time.perf_counter()
        run_tool("cluster_scaling_torch.py", "--out", str(full_path))
        full = json.loads(full_path.read_text())
    ref = full["reference"]
    print(f"[cluster] --quick equal to the reference's: "
          f"{quick['reference_equal']}; full run {time.perf_counter() - t0:.1f}"
          f" s ({full['wall_s']:.1f} s sweep): rank equal at "
          + ", ".join(f"{n} {v}" for n, v in ref["rank_equal"].items())
          + "; best plan equal " + json.dumps(ref["best_plan_equal"])
          + "; plan taus against BENCH_cluster.json " + json.dumps(
              {m: {n: round(t, 4) for n, t in v.items()}
               for m, v in ref["plan_tau"].items()}))
    out["cluster"] = {"quick_reference_equal": quick["reference_equal"],
                      "rank": full["rank"], "kendall_tau": full["kendall_tau"],
                      "against_reference": ref, "wall_s": full["wall_s"]}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[mesh] phase 30: {out['seconds']:.1f} s")
    return out


# phase 31: examples/train_lm_torch.py at --size 100m
TRAIN_LM_LOSS_RTOL = 1e-5
# the reference example's 300 steps cut to 200 (the fault at step 100):
# phase 34 needs the time the script's limit leaves
TRAIN_LM_STEPS = 200


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_lm_on_card(dev) -> dict:
    """Phase 31, ``examples/train_lm_torch.py`` at ``--size 100m`` and the
    reference example's defaults but ``TRAIN_LM_STEPS`` steps (of 8 x 256
    tokens, microbatch 4, lr 6e-4, f32 parameters and compute, checkpoints
    every 25 steps, a failure injected halfway): one restart, the loss
    falling by more than 0.5 (the example's own check), step ms, tokens/s
    and one checkpoint's save and restore seconds; then the same model
    trained without checkpoints or a failure to the step after the fault
    from the same seed: the
    resumed run's losses from the restored step to the step after the
    fault equal it, bit for bit if the card's run is deterministic, else
    within 1e-5 relative (the step's f32 reductions in another order).
    The dense model's path launches none of the hand-written kernels
    (attention ``blocked``: K3 has no backward), which is checked."""
    import tempfile

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.train import train_loop

    def counts():
        return {"flash_attention": fa.flash_attention_bhsd.launches,
                "ssd_scan": ssd.ssd_chunk.launches,
                "ssd_scan_bwd": ssd.ssd_chunk_bwd.launches}

    t_phase = time.perf_counter()
    ex = load_example("train_lm_torch")
    fa.flash_attention_bhsd.launches = ssd.ssd_chunk.launches = 0
    ssd.ssd_chunk_bwd.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        args = ex.parse_args(["--size", "100m", "--steps",
                              str(TRAIN_LM_STEPS), "--ckpt-dir",
                              str(Path(tmp) / "ckpt")])
        rep, stats = ex.run(args)
    launches = counts()
    torch.cuda.synchronize()
    at = ex.fault_step(args)
    restored = (at // ex.CKPT_EVERY) * ex.CKPT_EVERY
    model, run_cfg = ex.build(args)
    gc.collect()
    torch.cuda.empty_cache()
    clean = train_loop(model, run_cfg, n_steps=at + 2, seed=0,
                       log_every=ex.LOG_EVERY, device=dev)
    view = profile_train_step(dev, model, run_cfg, clean.state, at + 2)
    resumed = rep.losses[at:at + at + 2 - restored]
    want = clean.losses[restored:at + 2]
    equal_bits = (resumed == want and rep.losses[:at] == clean.losses[:at])
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        rep.losses[:at] + resumed, clean.losses[:at] + want))
    fell = stats["loss_last10"] < stats["loss_first10"] - ex.LOSS_DROP
    print(f"[train_lm] {run_cfg.model.name} "
          f"({run_cfg.model.param_count() / 1e6:.1f} M parameters, f32), "
          f"{args.steps} steps of {args.batch} x {args.seq} in microbatches "
          f"of {args.microbatch}, fault at step {at}: restarts "
          f"{rep.restarts}, restored at step {restored}; wall "
          f"{stats['wall_s']:.1f} s, {stats['tokens_per_s']:.0f} tokens/s, "
          f"median step {stats['median_step_ms']:.2f} ms (host clock); loss "
          f"{stats['loss_first10']:.4f} -> {stats['loss_last10']:.4f} (the "
          f"means of the first and last 10); a checkpoint of the final state "
          f"saved in {stats['ckpt_save_s']:.2f} s, restored in "
          f"{stats['ckpt_restore_s']:.2f} s; resumed losses at steps "
          f"{restored}-{at + 1} {resumed} against the uninterrupted run's "
          f"{want}: equal bits {equal_bits}, max rel {rel:.3e}; launches "
          f"{launches}")
    if rep.restarts != 1 or not fell:
        fail(f"train_lm: restarts {rep.restarts}, loss "
             f"{stats['loss_first10']} -> {stats['loss_last10']}")
    if not equal_bits and rel > TRAIN_LM_LOSS_RTOL:
        fail(f"train_lm: the resumed losses {resumed} differ from the "
             f"uninterrupted run's {want} by {rel:.3e}")
    if any(launches.values()):
        fail(f"train_lm launched {launches}; its path launches none")
    print(f"[train_lm] one more step (step {at + 2}) on the host clock "
          f"{view['host_ms']:.2f} ms; under the profiler {view['kernels']} "
          f"kernels, {view['kernel_ms']:.2f} ms of kernel time (cuBLAS "
          f"{view['cublas_ms']:.2f} ms), the device idle "
          f"{view['idle']:.1%}; the kernels that take most: " + ", ".join(
              f"{k[:60]} {v:.2f} ms" for k, v in view["top"].items()))
    del model, clean, rep
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[train_lm] phase 31: {seconds:.1f} s")
    return {"model": run_cfg.model.name,
            "params": run_cfg.model.param_count(), "steps": args.steps,
            "batch": args.batch, "seq": args.seq,
            "microbatch": args.microbatch, "fault_step": at,
            "restored_step": restored, "restarts": 1, **stats,
            "resumed_losses": resumed, "uninterrupted_losses": want,
            "equal_bits": equal_bits, "max_rel_loss_diff": rel,
            "profiled_step": view, "launches": launches, "seconds": seconds}


def profile_train_step(dev, model, run_cfg, state, step: int) -> dict:
    """One training step of ``state`` on synthetic batch ``step``: its host
    ms unprofiled, then under the profiler its kernels, kernel ms (cuBLAS
    apart), the device's idle share and the five kernels that take most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.launch.train import build_training

    step_fn = build_training(model, run_cfg, dev)[0]
    shape = run_cfg.shape
    batch = {"tokens": torch.from_numpy(SyntheticLMDataset(
        run_cfg.model.vocab_size, shape.seq_len, shape.global_batch,
        seed=0).batch(step)["tokens"]).to(dev, torch.long)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_fn(*state, batch)
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(*state, batch)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.self_device_time_total
    busy = sum(by_name.values()) / 1e3
    cublas = sum(v for k, v in by_name.items()
                 if any(c in k.lower() for c in CUBLAS_FUNCTIONS)) / 1e3
    top = dict(sorted(((k, v / 1e3) for k, v in by_name.items()),
                      key=lambda kv: -kv[1])[:5])
    return {"host_ms": host * 1e3, "kernels": len(kern), "kernel_ms": busy,
            "cublas_ms": cublas, "idle": max(0.0, 1 - busy / (host * 1e3)),
            "top": top}


# phase 32: the SSD kernel-cost bench's rows beside the card's times
def ssd_cost_on_card(dev, check_kernels) -> dict:
    """Phase 32, ``tools/ssd_kernel_cost_torch.py`` (the plain chunked
    path's captured bytes and FLOPs against K4's and K5's bounds, as
    memory and compute terms on the ``H100`` spec) and, at its shape, the
    card's device time (each call behind a spin, as in phase 10) of K4 +
    K5 and of the plain chunked forward + backward (``ssd_chunked`` and
    ``torch.autograd.grad``), with the kernel path's forward + backward
    (``ops.ssd_scan``: K4, K5 and the recurrence) beside them.  The kernel
    path runs once with the counts at 0 first (K4 and K5 once each), and
    K4 and K5 are held against their plain versions at the shapes it
    launched them with (``check_kernels``)."""
    import tempfile

    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.bounds import (ssd_chunk_bwd_bound,
                                            ssd_chunk_fwd_bound)
    from repro_torch.models.ssm import ssd_chunked

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ssd_kernel_cost.json"
        run_tool("ssd_kernel_cost_torch.py", "--out", str(path))
        rows = json.loads(path.read_text())
    sh = rows["shape"]
    B, L, H, P, N, Q = (sh[k] for k in ("B", "S", "H", "P", "N", "chunk"))
    nc = L // Q
    gen = torch.Generator(device=dev).manual_seed(32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(B, L, H, P).bfloat16()
    dt = torch.nn.functional.softplus(randn(B, L, H)).bfloat16()
    A = -torch.exp(0.5 * randn(H))
    Bg, Cg = ((0.5 * randn(B, L, 1, N)).bfloat16() for _ in range(2))
    Bh, Ch = (t.expand(B, L, H, N) for t in (Bg, Cg))

    def kernel_path():
        xl, dtl = (t.detach().requires_grad_(True) for t in (x, dt))
        y, st = kops.ssd_scan(xl, dtl, A, Bh, Ch, Q)
        return torch.autograd.grad(y.float().sum() + st.float().sum(),
                                   (xl, dtl))

    def plain_path():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, dt.float(), A, Bg, Cg)]
        y, st = ssd_chunked(*leaves, Q)
        return torch.autograd.grad(y.float().sum() + st.float().sum(),
                                   leaves)

    shapes = {name: set() for name in KERNELS}
    with recording_shapes(shapes):
        ssd.ssd_chunk.launches = ssd.ssd_chunk_bwd.launches = 0
        kernel_path()
        torch.cuda.synchronize()
        launches = {"ssd_scan": ssd.ssd_chunk.launches,
                    "ssd_scan_bwd": ssd.ssd_chunk_bwd.launches}
    if launches != {"ssd_scan": 1, "ssd_scan_bwd": 1}:
        fail(f"phase 32: the kernel path launched {launches}")
    checks = check_kernels(shapes)

    args = [t.reshape(B, nc, Q, *t.shape[2:]) for t in (x, dt)] + [A] + [
        t.reshape(B, nc, Q, *t.shape[2:]) for t in (Bh, Ch)]
    dy = randn(B, nc, Q, H, P).bfloat16()
    dstates, dgamma = randn(B, nc, H, N, P), randn(B, nc, H)
    k4_ms = device_ms(lambda: ssd.ssd_chunk(*args), 30)
    k5_ms = device_ms(lambda: ssd.ssd_chunk_bwd(*args, dy, dstates, dgamma),
                      30)
    kernel_path_ms = device_ms(kernel_path, 10)
    plain_ms = device_ms(plain_path, 10)
    k4 = ssd_chunk_fwd_bound(B, L, H, P, N, Q)
    k5 = ssd_chunk_bwd_bound(B, L, H, P, N, Q)
    scale = sh["layers"] * sh["microbatches"]
    plain, ker = rows["plain_chunked"], rows["kernels"]
    print(f"[ssd_cost] B={B} S={L} H={H} P={P} N={N} chunk {Q} (mamba2-1.3b "
          f"train_4k's per-device shape), per layer and microbatch; "
          f"modelled on {rows['spec']['name']} (bytes over "
          f"{rows['spec']['hbm_read_bw'] / 1e12:g} TB/s, FLOPs over "
          f"{rows['spec']['peak_bf16'] / 1e12:g} TFLOP/s): plain chunked "
          f"{plain['bytes'] / 2**20:.2f} MiB, {plain['flops'] / 1e9:.3f} GF "
          f"(dots {plain['dot_flops'] / 1e9:.3f} GF): memory "
          f"{plain['memory_term_s'] / scale * 1e3:.4f} ms, compute "
          f"{plain['compute_term_s'] / scale * 1e3:.4f} ms; kernels K4 "
          f"{ker['k4']['bytes'] / 2**20:.2f} MiB + K5 "
          f"{ker['k5']['bytes'] / 2**20:.2f} MiB + outside them "
          f"{ker['outside_kernels']['bytes'] / 2**20:.2f} MiB = "
          f"{ker['bytes'] / 2**20:.2f} MiB, {ker['flops'] / 1e9:.3f} GF: "
          f"memory {ker['memory_term_s'] / scale * 1e3:.4f} ms, compute "
          f"{ker['compute_term_s'] / scale * 1e3:.4f} ms; HBM traffic cut "
          f"{rows['hbm_traffic_cut']:.1%}; the step's ({sh['layers']} "
          f"layers x {sh['microbatches']} microbatches) memory terms "
          f"{plain['memory_term_s']:.4f} s and {ker['memory_term_s']:.4f} s")
    print(f"[ssd_cost] on the card (device time, behind a spin): K4 "
          f"{k4_ms:.4f} ms (bound {k4.bound_ms:.4f}, {k4.bound_by}) + K5 "
          f"{k5_ms:.4f} ms (bound {k5.bound_ms:.4f}, {k5.bound_by}) = "
          f"{k4_ms + k5_ms:.4f} ms; the kernel path's forward + backward "
          f"{kernel_path_ms:.4f} ms; the plain chunked forward + backward "
          f"{plain_ms:.4f} ms ({plain_ms / (k4_ms + k5_ms):.2f}x K4 + K5, "
          f"{plain_ms / kernel_path_ms:.2f}x the kernel path); x "
          f"{scale} a step: K4 + K5 {(k4_ms + k5_ms) * scale / 1e3:.3f} s, "
          f"plain {plain_ms * scale / 1e3:.3f} s; launches {launches}; "
          f"against the plain versions {checks}")
    del x, dt, A, Bg, Cg, Bh, Ch, args, dy, dstates, dgamma
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[ssd_cost] phase 32: {seconds:.1f} s")
    return {"modelled": rows, "k4_ms": k4_ms, "k5_ms": k5_ms,
            "k4_bound_ms": k4.bound_ms, "k5_bound_ms": k5.bound_ms,
            "kernel_path_ms": kernel_path_ms, "plain_ms": plain_ms,
            "launches": launches, "kernel_checks": checks,
            "seconds": seconds}


# phase 33: one full-width cell on the fake production meshes
CELL_ARCH, CELL_SHAPE = "chatglm3-6b", "decode_32k"
CELL_MESHES = (("16x16", ()), ("2x16x16", ("--multi-pod",)))
CELL_TIMEOUT_S = 600


def start_cell_captures(tmp: Path) -> dict:
    """Phase 33's two processes, started side by side (host work: they run
    while phases 31 and 32 use the card): ``tools/cell_capture_torch.py``
    for each production mesh, writing under ``tmp``."""
    import os
    procs = {}
    for name, flag in CELL_MESHES:
        log = open(tmp / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / "tools" / "cell_capture_torch.py"),
             "--arch", CELL_ARCH, "--shape", CELL_SHAPE, *flag, "--out",
             str(tmp / f"{name}.json")], stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")}), log,
            time.perf_counter())
    return procs


def cell_on_production_meshes(tmp: Path, procs: dict) -> dict:
    """Phase 33, ``tools/cell_capture_torch.py``: ``build_cell(CELL_ARCH,
    CELL_SHAPE, make_production_mesh()).capture()`` at full width on the
    (16, 16) and the (2, 16, 16) mesh, each in a process of its own over a
    fake process group of 256 or 512 ranks (apart from phase 30's real
    one; ``start_cell_captures`` started them), parsed and simulated on
    ``H100``: the capture's and parse's seconds and the process's peak
    resident memory (host numbers of the card's machine, not card times),
    graph nodes, ops, collective bytes by kind and group size, the bytes by
    opcode and the ops that move the most, and the simulated step time."""
    out = {}
    for name, (proc, log, t0) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, CELL_TIMEOUT_S
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at the time limit"
        log.close()
        if rc != 0:
            fail(f"phase 33: cell_capture_torch.py on {name} exited {rc}: "
                 f"{(tmp / f'{name}.log').read_text()[-2000:]}")
        r = json.loads((tmp / f"{name}.json").read_text())
        out[name] = r
        print(f"[cell] {r['cell']} at full width on the fake {name} mesh "
              f"({r['n_chips']} ranks; host numbers, the process beside "
              f"phases 31-32): the run {r['wall_s']:.2f} s, of it mesh "
              f"{r['mesh_s']:.2f} s, capture "
              f"{r['capture_s']:.2f} s, parse {r['parse_s']:.2f} s, simulate "
              f"{r['simulate_s']:.2f} s, peak RSS "
              f"{r['peak_rss_bytes'] / 2**30:.2f} GiB; {r['graph_nodes']} "
              f"graph nodes, {r['ops']} ops, {r['flops'] / 1e9:.3f} GFLOP "
              f"and {r['bytes'] / 2**30:.3f} GiB a rank, collectives "
              + ", ".join(f"{k}: {v['count']} ops {v['bytes'] / 2**20:.2f} "
                          f"MiB" for k, v in r["collectives"].items())
              + f"; t_est on {r['spec']} {r['t_est_s'] * 1e3:.3f} ms "
              f"(compute {r['roofline']['compute_s'] * 1e3:.3f}, memory "
              f"{r['roofline']['memory_s'] * 1e3:.3f}, collective "
              f"{r['roofline']['collective_s'] * 1e3:.3f} ms); GiB by opcode "
              + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in sorted(
                  r["bytes_by_opcode"].items(), key=lambda kv: -kv[1])[:6])
              + "; the ops that move the most: " + ", ".join(
                  f"{o['name']} ({o['opcode']}, {o['dtype']}) "
                  f"{o['bytes'] / 2**20:.1f} MiB" for o in r["top_ops"][:5]))
        if not (r["ops"] > 0 and r["collectives"] and r["t_est_s"] > 0):
            fail(f"phase 33: the {name} capture holds {r['ops']} ops "
                 f"and collectives {r['collectives']}")
    print("[cell] phase 33: " + ", ".join(
        f"{n} {r['wall_s']:.1f} s" for n, r in out.items())
        + " (processes beside phases 31-32)")
    return out

# phase 34: the dry-run, its analysis and tables; the memory analysis
DRYRUN_CELLS = (("chatglm3-6b", "prefill_32k"),      # repair (b)
                ("mamba2-1.3b", "decode_32k"))       # repair (c)
DRYRUN_TIMEOUT_S = 600
MEM_RATIO = (0.5, 1.05)
RESHARD_PROBE = r"""
import json, torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core import aten
from repro_torch.launch.cell import capture_on_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                  mesh_dim_names=("data", "model"))
def body(x):
    d = DTensor.from_local(x, mesh, [Replicate(), Shard(0)], run_check=False)
    return d.redistribute(mesh, [Replicate(), Shard(1)]).to_local()
prog = aten.parse_graph(capture_on_mesh(body, torch.randn(16, 256)))
print(json.dumps([(o.opcode, o.comm_bytes, o.group_size)
                  for o in prog.ops if o.opclass == "collective"]))
dist.destroy_process_group()
"""


def start_dryrun(tmp: Path) -> dict:
    """Phase 34's processes, started after phase 31 (host work, one torch
    thread each, beside phases 32-33 and the memory check): the dry-run CLI
    on ``DRYRUN_CELLS`` (single pod, ``--jobs 2``) and ``launch.analyze``
    on phase 33's cell."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    cmds = {"dryrun": [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--mesh", "single", "--jobs", "2", "--force",
                       "--out", str(tmp / "dryrun"),
                       *(x for a, s_ in DRYRUN_CELLS
                         for x in ("--cell", f"{a}/{s_}"))],
            "analyze": [sys.executable, "-m", "repro_torch.launch.analyze",
                        "--arch", CELL_ARCH, "--shape", CELL_SHAPE,
                        "--top", "10"]}
    procs = {}
    for name, cmd in cmds.items():
        log = open(tmp / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT, env=env,
                                        cwd=ROOT), log, time.perf_counter())
    return procs


def dryrun_phase(tmp: Path, procs: dict) -> dict:
    """Phase 34, the dry-run and what reads it (host numbers of the card's
    machine; modelled terms, not card times): ``python -m
    repro_torch.launch.dryrun`` on chatglm3-6b prefill_32k (its heads split
    per rank, repair b) and mamba2-1.3b decode_32k (its batched products on
    local shards, repair c) on the fake (16, 16) mesh, each cell's capture
    seconds, peak resident memory, peak bytes a rank, collectives by kind
    and dominant term; ``launch.analyze`` on phase 33's cell;
    ``tools/roofline_table_torch.py`` on the artifacts; and repair (a)'s
    probe on this torch: a Shard(0) -> Shard(1) redistribution captured as
    ``Cell.capture`` captures it is one all-to-all of the local shard."""
    import io
    import os
    from contextlib import redirect_stdout

    sys.path.insert(0, str(ROOT / "tools"))
    import roofline_table_torch

    out = {}
    for name, (proc, log, t0) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at the time limit"
        log.close()
        text = (tmp / f"{name}.log").read_text()
        if rc != 0:
            fail(f"phase 34: {name} exited {rc}: {text[-3000:]}")
        out[name] = {"seconds": time.perf_counter() - t0, "log": text}
    if "all cells captured" not in out["dryrun"]["log"]:
        fail(f"phase 34: the dry-run did not capture every cell: "
             f"{out['dryrun']['log'][-2000:]}")
    cells = {}
    for arch, shape in DRYRUN_CELLS:
        r = json.loads((tmp / "dryrun" / "single_pod" /
                        f"{arch}__{shape}.json").read_text())
        mem, rf = r["memory_analysis"], r["roofline"]
        cells[f"{arch}/{shape}"] = {
            "capture_s": r["t_lower_s"], "parse_sim_s": r["t_compile_s"],
            "peak_rss_gib": r["peak_rss_bytes"] / 2**30,
            "peak_gib_a_rank": mem["peak_bytes_est"] / 2**30,
            "memory_analysis": mem, "collectives": r["collectives"],
            "roofline": rf, "fits_hbm": r["fits_hbm"],
            "graph_nodes": r["graph_nodes"]}
        print(f"[dryrun] {arch} {shape} single_pod ({r['n_chips']} fake "
              f"ranks; host numbers): capture {r['t_lower_s']:.2f} s, parse "
              f"+ simulate {r['t_compile_s']:.2f} s, peak RSS "
              f"{r['peak_rss_bytes'] / 2**30:.2f} GiB, {r['graph_nodes']} "
              f"graph nodes; peak {mem['peak_bytes_est'] / 2**30:.2f} GiB a "
              f"rank (arguments {mem['argument_bytes'] / 2**30:.2f}, temp "
              f"{mem['temp_bytes'] / 2**30:.2f}, fits "
              f"{r['hbm_per_chip'] / 1e9:.0f} GB: {r['fits_hbm']}); "
              f"collectives " + ", ".join(
                  f"{k}: {v['count']} ops {v['bytes'] / 2**20:.1f} MiB"
                  for k, v in sorted(r["collectives"].items()))
              + f"; dominant {rf['dominant']} (compute "
              f"{rf['compute_s'] * 1e3:.3f}, memory {rf['memory_s'] * 1e3:.3f}"
              f", collective {rf['collective_s'] * 1e3:.3f} ms, modelled)")
        if not (r["roofline"]["dominant"] and r["collectives"]
                and mem["peak_bytes_est"] > 0):
            fail(f"phase 34: {arch} {shape}'s artifact {r}")
    analyze = out["analyze"]["log"]
    for key in ("== PA report", "memory_analysis: {", "== top 10 ops",
                "== op-count histogram"):
        if key not in analyze:
            fail(f"phase 34: analyze printed no {key!r}: {analyze[-2000:]}")
    top = analyze.split("== top 10 ops by modeled time ==\n")[1]
    print(f"[dryrun] launch.analyze {CELL_ARCH} {CELL_SHAPE} (16, 16) in "
          f"{out['analyze']['seconds']:.1f} s: "
          + next(line.strip() for line in analyze.splitlines()
                 if line.strip().startswith("estimate:")))
    for line in top.splitlines()[:4]:
        print(f"[dryrun]   {line}")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = roofline_table_torch.main(["--dir", str(tmp / "dryrun")])
    if rc:
        fail("phase 34: roofline_table_torch.py found no artifacts")
    for line in buf.getvalue().splitlines():
        print(f"[dryrun] {line}")
    probe = subprocess.run([sys.executable, "-c", RESHARD_PROBE],
                           capture_output=True, text=True, timeout=300,
                           env={**os.environ,
                                "PYTHONPATH": str(ROOT / "src")})
    rows = (json.loads(probe.stdout.splitlines()[-1])
            if probe.returncode == 0 else None)
    print(f"[dryrun] repair (a) on torch's own DTensor here: a Shard(0) -> "
          f"Shard(1) redistribution of a (64, 256) f32 tensor over the "
          f"4-rank 'model' axis captured as {rows}")
    if rows != [["all-to-all", 16 * 256 * 4, 4]]:
        fail(f"phase 34: the reshard probe gave {rows}: "
             f"{probe.stderr[-2000:]}")
    return {"cells": cells, "reshard_probe": rows,
            "dryrun_s": out["dryrun"]["seconds"],
            "analyze_s": out["analyze"]["seconds"]}


def memory_vs_allocator(dev, step_sims) -> list:
    """Phase 34's ``[mem]`` lines: ``core.aten.memory_analysis``'s output +
    temp bytes of phase 19's captures of mamba2-1.3b's training step (the
    kernel path) and chatglm3-6b's 2048-token prefill (flash), beside
    ``torch.cuda.max_memory_allocated()`` of one real run of the same call,
    from ``reset_peak_memory_stats()`` once its inputs exist (less what is
    allocated then).  The graph's order frees each tensor at its last
    read and eager frees it no earlier, so the estimate should not exceed
    the allocator's peak; it fails outside ``MEM_RATIO`` of it."""
    import torch

    from repro_torch.configs import ARCHS, RunConfig, ShapeConfig
    from repro_torch.models.lm import build_model
    from repro_torch.train.trainer import make_train_step

    def captured(label):
        row = next((r for r in step_sims if r["capture"] == label), None)
        if row is None:
            fail(f"[mem] phase 19 captured no {label!r}")
        return row["memory_analysis"]

    def train_case():
        cfg = ARCHS[SSM_ARCH]
        run = RunConfig(model=cfg, shape=ShapeConfig(
            "smoke", TRAIN_SEQ, SSM_TRAIN_BATCH, "train"))
        model = build_model(cfg, ssd_impl="kernel")
        step, *_, opt_init = make_train_step(model, run)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype=getattr(torch, run.param_dtype))
        return (f"{SSM_ARCH} training step {SSM_TRAIN_BATCH} x {TRAIN_SEQ}, "
                "kernel path", step,
                (params, opt_init(params),
                 {"tokens": torch.zeros((SSM_TRAIN_BATCH, TRAIN_SEQ),
                                        dtype=torch.long, device=dev)}))

    def prefill_case():
        model = build_model(ARCHS["chatglm3-6b"], attn_impl="flash",
                            ssd_impl="kernel")
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16)
        return (f"chatglm3-6b prefill {TRAIN_SEQ}, kernel path",
                prefill_of(model),
                (params, {"tokens": torch.zeros((1, TRAIN_SEQ),
                                                dtype=torch.long,
                                                device=dev)}))

    rows = []
    for make in (train_case, prefill_case):
        label, fn, real = make()
        mem = captured(label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(*real)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out, real, fn
        gc.collect()
        torch.cuda.empty_cache()
        est = mem["output_bytes"] + mem["temp_bytes"]
        ratio = est / peak
        print(f"[mem] {label}: memory_analysis output + temp "
              f"{est / 2**30:.3f} GiB (output {mem['output_bytes'] / 2**30:.3f}"
              f", temp {mem['temp_bytes'] / 2**30:.3f}, arguments "
              f"{mem['argument_bytes'] / 2**30:.3f}) against the allocator's "
              f"peak over its inputs {peak / 2**30:.3f} GiB: ratio "
              f"{ratio:.3f} (must lie in {MEM_RATIO})")
        if not MEM_RATIO[0] <= ratio <= MEM_RATIO[1]:
            fail(f"[mem] {label}: ratio {ratio:.3f} outside {MEM_RATIO}")
        rows.append({"case": label, "estimate_bytes": est,
                     "allocator_peak_bytes": peak, "ratio": ratio,
                     "memory_analysis": mem})
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    global PEAK_BF16_FLOPS, PEAK_F32_FLOPS, HBM_BYTES_PER_S
    from repro_torch.kernels import bounds
    from repro_torch.kernels.bounds import (ssd_chunk_bwd_bound,
                                            ssd_chunk_fwd_bound)
    PEAK_BF16_FLOPS = bounds.PEAK_BF16_FLOPS
    PEAK_F32_FLOPS = bounds.PEAK_F32_FLOPS
    HBM_BYTES_PER_S = bounds.HBM_BYTES_PER_S

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

    bwd_lib = next(b.lib for b in builds if b.name == "ssd_scan_bwd")
    for dtype, code in (("float32", 0), ("bfloat16", 1)):
        for p_max in (64, 128):
            for n_max in (64, 128, 256):
                parts = bwd_lib.repro_ssd_chunk_bwd_parts(p_max, n_max)
                print(f"[build] ssd_scan_bwd instance {dtype} P<={p_max} "
                      f"N<={n_max}: dynamic shared memory, column / row CTA "
                      f"{bwd_lib.repro_ssd_chunk_bwd_smem_bytes(code, p_max, n_max, 0)}"
                      f" / {bwd_lib.repro_ssd_chunk_bwd_smem_bytes(code, p_max, n_max, 1)}"
                      f" B; dB and dC in {parts} column part(s); per tile "
                      f"pair and head, s = C.B^T formed 1x (the column CTA "
                      f"of part 0), dM = dy.x^T {2 * parts}x (column and "
                      f"row CTAs of every part); with B/C shared by the "
                      f"heads s is formed for each head")

    # K4: every instance without a spill and without serialized wgmma
    fwd = next(b for b in builds if b.name == "ssd_scan")
    print(f"[build] ssd_scan dynamic shared memory a CTA, f32 / bf16: "
          f"{fwd.lib.repro_ssd_chunk_fwd_smem_bytes(0)} / "
          f"{fwd.lib.repro_ssd_chunk_fwd_smem_bytes(1)} B; C.B^T formed once "
          f"per 64-row tile, head block and 64 columns of P where B and C "
          f"are shared by the heads")
    spills = [line.strip() for line in fwd.log.splitlines()
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
    serialized = [line.strip() for line in fwd.log.splitlines()
                  if "wgmma" in line and "serialized" in line]
    n_k4 = sum("Compiling entry function" in line and "ssd_chunk_fwd" in line
               for line in fwd.log.splitlines())
    print(f"[build] ssd_scan: {n_k4} kernel instances, {len(spills)} with a "
          f"spill, {len(serialized)} lines of serialized wgmma (C75xx)")
    if spills or serialized or n_k4 == 0:
        fail(f"K4's ptxas report: spills {spills}, serialized wgmma "
             f"{serialized}, {n_k4} instances")

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
        compare(1, s, s, h, kvh, d, causal, "bfloat16", bshd=True)
        for _, h, kvh, d, s, causal in FLASH_TIMING)))

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

    def compare_ssd(B, L, H, P, N, chunk, dtype, broadcast, rising=None):
        """K4 against its plain version, and against itself run twice;
        outside the precondition of K4's factorization of exp(cs_i - cs_j),
        which the kernel checks per head, with ``rising`` "rows": dt < 0 on
        40 rows of the odd heads (cs rises there, by under 2); "A": A > 0
        on the odd heads (0.002, 0.005 at H 4), so cs rises over the whole
        chunk, where y from f32 inputs is held to twice its tolerance (the
        documented limit of the split products: 1.25 times it against f64
        in the CPU emulation, tests/test_torch_ssd_fwd_precision.py)."""
        Q = min(chunk, L)
        nc = L // Q
        x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, dtypes[dtype], broadcast)
        if rising == "rows":
            dt = dt.clone()
            dt[:, 100:140, 1::2] *= -0.05
        elif rising == "A":
            A = A.clone()
            A[1::2] = torch.tensor(RISING_A, device=dev)[1::2][:H // 2]
        y_limit = 2 if rising == "A" and dtype == "float32" else 1
        args = [t[:, :nc * Q].reshape(B, nc, Q, *t.shape[2:])
                for t in (x, dt)] + [A] + [
                t[:, :nc * Q].reshape(B, nc, Q, *t.shape[2:])
                for t in (Bm, Cm)]
        if broadcast and args[3].stride(3) != 0:
            fail("the head-broadcast B was copied")
        got = ssd.ssd_chunk(*args)
        same_bits = bit_identical(got, ssd.ssd_chunk(*args))
        want = ssd.ssd_chunk_plain(*args)
        errs, used = [], 0.0
        for g, w, tol in zip(got, want, (y_limit * SSD_TOL[dtype],
                                         SSD_F32_TOL, SSD_F32_TOL)):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"K4 output {tuple(g.shape)} {g.dtype}, plain "
                     f"{tuple(w.shape)} {w.dtype}")
            diff = (g.float() - w.float()).abs()
            errs.append(diff.max().item())
            used = max(used, (diff / (tol + tol * w.float().abs())).max()
                       .item())
        ok = same_bits and used <= 1 and all(torch.isfinite(g).all()
                                             for g in got)
        where = {None: "", "rows": ", cs rising on rows of the odd heads",
                 "A": ", cs rising over the chunk on the odd heads (A > 0)"}
        print(f"[check] K4 B={B} nc={nc} Q={Q} H={H} P={P} N={N} {dtype} "
              f"{'broadcast' if broadcast else 'contiguous'} B/C"
              f"{where[rising]}: max|err| "
              f"y {errs[0]:.3e}, states {errs[1]:.3e}, gamma {errs[2]:.3e}; "
              f"{used:.1%} of |err| <= tol + tol|plain| (y "
              f"{y_limit * SSD_TOL[dtype]:g}, states/gamma {SSD_F32_TOL:g}); "
              f"two runs "
              f"{'bit-identical' if same_bits else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K4 disagrees with its plain version (or two K4 runs "
                 f"differ) at {(B, L, H, P, N, chunk, dtype, broadcast)}")
        return max(errs), used

    ssd_checks = {}
    for shape in SSD_GRID + SSD_BWD_GRID[4:]:   # and the training shapes
        for dtype in ("float32", "bfloat16"):
            for broadcast in (False, True):
                ssd_checks[shape, dtype, broadcast] = compare_ssd(
                    *shape, dtype, broadcast)
    for rising in ("rows", "A"):
        for dtype in ("float32", "bfloat16"):
            compare_ssd(2, 512, 4, 64, 128, 256, dtype, True, rising=rising)
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
        same_bits = bit_identical(got, ssd.ssd_chunk_bwd(*args, dy, dstates,
                                                         dgamma))
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
        ok = same_bits and max(used.values()) <= 1 and all(
            torch.isfinite(g).all() for g in got)
        print(f"[check] K5 B={B} nc={nc} Q={Q} H={H} P={P} N={N} {dtype} "
              f"{'broadcast' if broadcast else 'contiguous'} B/C: max|err| "
              "against plain " + ", ".join(f"{k} {v:.3e}" for k, v in
                                           errs.items())
              + "; share of the tolerance " + ", ".join(
                  f"{k} {v:.1%}" for k, v in used.items())
              + f"; two runs {'bit-identical' if same_bits else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K5, its plain version and f64 disagree (or two K5 runs "
                 f"differ) at "
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

    def serve_full(arch, prompt_lens, new_tokens, want, cfg=None,
                   extra_inputs=None):
        """Seeded bf16 weights, one request at a time through
        ServeEngine.generate (with ``extra_inputs``, the vlm's image
        embeddings or the audio's frames); checks each kernel's launch
        count against ``want`` and every token's range; for an MoE model
        counts the assignments each request's prefill and decode dropped at
        capacity.  ``cfg`` overrides the registry's (a depth cut).  Returns
        (serving record, model, params, engine, prompts)."""
        cfg = cfg or ARCHS[arch]
        model = build_model(cfg, attn_impl="flash", ssd_impl="kernel")
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in pr.leaves(params))
        print(f"[serve] {arch}: {n_params / 1e9:.3f} B parameters in bf16 "
              f"({n_params * 2 / 1e9:.2f} GB; {cfg.n_layers} layers), drawn "
              f"in {time.perf_counter() - t0:.1f} s")
        if n_params != cfg.param_count():
            fail(f"{n_params} parameters, config says {cfg.param_count()}")
        rng = np.random.default_rng(0)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
                   for n in prompt_lens]
        engine = ServeEngine(model, params,
                             max_seq=max(prompt_lens) + new_tokens, device=dev)
        # warm-up; a vlm prompt holds at least its image rows
        engine.generate([prompts[0][:max(16, cfg.n_img_tokens)]],
                        max_new_tokens=2, extra_inputs=extra_inputs)
        torch.cuda.synchronize()
        if cfg.moe is not None:
            model.moe_dropped = []     # one 0-d tensor a layer and call
        drops = []
        reset_launches()
        timings, peaks, outs = [], [], []
        t_all = time.perf_counter()
        for prompt in prompts:          # one call each: peak memory per request
            torch.cuda.reset_peak_memory_stats()
            outs += engine.generate([prompt], max_new_tokens=new_tokens,
                                    extra_inputs=extra_inputs)
            peaks.append(torch.cuda.max_memory_allocated())
            timings += engine.timings
            if model.moe_dropped is not None:
                per_call = [int(t) for t in model.moe_dropped]
                model.moe_dropped.clear()
                drops.append({"prefill": sum(per_call[:cfg.n_layers]),
                              "decode": sum(per_call[cfg.n_layers:])})
        wall = time.perf_counter() - t_all
        model.moe_dropped = None
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
            "peak_mem_bytes": peaks, "launches": got,
            "layers": cfg.n_layers}
        if drops:
            record["moe_dropped"] = drops
            k = cfg.moe.top_k
            for n, d in zip(prompt_lens, drops):
                print(f"[serve] {arch} prompt {n:5d}: capacity dropped "
                      f"{d['prefill']} of {n * k * cfg.n_layers} prefill "
                      f"assignments ({n} tokens x top-{k} x {cfg.n_layers} "
                      f"layers) and {d['decode']} in decode")
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

    def trace_serving(arch, model, params, engine, prompt, steps=8,
                      extra_inputs=None):
        """Where the device time goes: one prefill of ``prompt`` and
        ``steps`` decode steps after it, each on the host clock unprofiled,
        then under the profiler (kernel time, each port kernel's share, the
        number of kernels, the device's idle share)."""
        extra = extra_inputs or {}
        with torch.inference_mode():
            toks = torch.tensor([prompt], device=dev)
            _, cache = engine._prefill_one(prompt, extra)
            tok = torch.zeros((1, 1), dtype=torch.long, device=dev)

            def prefill():
                model.prefill_fn(params, {"tokens": toks, **extra})

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
    # Each call is queued behind a device-side spin longer than the host
    # takes to queue it (core/calibrate.py's _median_time), so the events
    # around it time the card, not the wrapper's per-call host cost (checks,
    # allocation, ctypes, three tensor-map encodes), which exceeds K3's time
    # at S = 512.
    from repro_torch.core import calibrate as cal
    sdpa = torch.nn.functional.scaled_dot_product_attention
    print(f"[time] flash: the median of {FLASH_REPEATS} calls (plain: 3), "
          f"each queued behind a device-side spin of at least "
          f"{cal.SPIN_CYCLES} cycles and twice the host's time to queue the "
          f"previous call, CUDA events around the call alone; q, k, v "
          f"(B,S,H,D) views as the models pass them")
    flash_rows = []
    for label, H, KVH, D, S, causal in FLASH_TIMING:
        q, k, v = (torch.randn((1, S, n, D), generator=gen, device=dev)
                   .bfloat16().transpose(1, 2) for n in (H, KVH, KVH))
        kernel_ms = cal._median_time(
            lambda q: fa.flash_attention_bhsd(q, k, v, causal=causal), (q,),
            FLASH_REPEATS) * 1e3
        plain_ms = cal._median_time(
            lambda q: fa.flash_attention_plain(q, k, v, causal=causal), (q,),
            3) * 1e3
        library_ms = cal._median_time(
            lambda q: sdpa(q, k, v, is_causal=causal, enable_gqa=True), (q,),
            FLASH_REPEATS) * 1e3
        pairs = S * (S + 1) // 2 if causal else S * S   # (query, key) pairs
        flops = 4 * H * D * pairs                # q.k and p.v
        nbytes = 2 * (2 * H * S * D + 2 * KVH * S * D)   # q, o; k, v
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        row = {"shape": f"{label} B=1 H={H} KVH={KVH} S={S} D={D} bf16 "
                        f"{'causal' if causal else 'no mask'}",
               "ms": kernel_ms, "plain_ms": plain_ms,
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

    # 10. K4 timing at mamba2-1.3b's prefill and training shapes and at
    # zamba2-1.2b's prefill shape ------------------------------------------
    k4_times = []
    for label, B, cfg_t in ((f"{SSM_ARCH} prefill", 1, ssm_cfg),
                            (f"{SSM_ARCH} training", SSM_TRAIN_BATCH, ssm_cfg),
                            (f"{HYBRID_ARCH} prefill", 1, hyb_cfg)):
        sc, L = cfg_t.ssm, TIMING_S
        H, P, N, Q = sc.n_heads(cfg_t.d_model), sc.head_dim, sc.d_state, sc.chunk
        nc = L // Q
        pairs = Q * (Q + 1) // 2                  # causal (i, j) pairs
        x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, torch.bfloat16, True)
        args = [t.reshape(B, nc, Q, *t.shape[2:]) for t in (x, dt)] + [A] + [
            t.reshape(B, nc, Q, *t.shape[2:]) for t in (Bm, Cm)]
        shape = f"B={B} nc={nc} Q={Q} H={H} P={P} N={N} bf16, B/C broadcast"
        k4_ms = device_ms(lambda: ssd.ssd_chunk(*args), 30)
        k4_plain_ms = device_ms(lambda: ssd.ssd_chunk_plain(*args), 3)
        # the bound: kernels/bounds.py (C.B^T once per group, M.X and the
        # state's f32 operands as hi and lo bf16 halves)
        bd = ssd_chunk_fwd_bound(B, L, H, P, N, Q, sc.n_groups)
        bound_ms, bound_by = bd.bound_ms, bd.bound_by
        print(f"[time] K4 {label}, {shape} (device time, behind a spin): "
              f"kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by}: tensor cores "
              f"{bd.ops_s * 1e3:.4f} ms (C.B^T {bd.flops_cb / 1e9:.4f} "
              f"GFLOP, M.X and the state {bd.flops_f32 / 1e9:.3f} GFLOP "
              f"twice, hi and lo, over {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s "
              f"bf16), bytes {bd.bytes_s * 1e3:.4f} ms ({bd.bytes / 1e6:.2f} "
              f"MB over {HBM_BYTES_PER_S / 1e12:g} TB/s); the bound with M.X "
              f"and the state as f32 FMAs on the CUDA cores "
              f"{bd.cuda_core_s * 1e3:.4f} ms; kernel at "
              f"{bound_ms / k4_ms:.1%} of the bound, "
              f"{k4_plain_ms / k4_ms:.2f}x faster than plain; no single "
              f"PyTorch call computes this function")
        k4_times.append({"label": label, "shape": shape, "ms": k4_ms,
                         "plain_ms": k4_plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by})
        del x, dt, A, Bm, Cm, args
        gc.collect()
        torch.cuda.empty_cache()
    # phase 14 times K5 at mamba2-1.3b's training shape
    sc = ssm_cfg.ssm
    H, P, N, Q = sc.n_heads(ssm_cfg.d_model), sc.head_dim, sc.d_state, sc.chunk
    pairs = Q * (Q + 1) // 2

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
        step_fn, *_ = build_training(model, run, dev)

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
    k5_ms = device_ms(lambda: ssd.ssd_chunk_bwd(*args, dy, dstates, dgamma), 20)
    t0 = time.perf_counter()   # the host's time to queue one call, no wait
    ssd.ssd_chunk_bwd(*args, dy, dstates, dgamma)
    k5_host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    k5_plain_ms = device_ms(
        lambda: ssd.ssd_chunk_bwd_plain(*args, dy, dstates, dgamma), 3)
    # the bound: kernels/bounds.py
    k5_bound = ssd_chunk_bwd_bound(B, L, H, P, N, Q, sc.n_groups)
    k5_bound_ms = k5_bound.bound_ms
    print(f"[time] K5 B={B} nc={nc} Q={Q} H={H} P={P} N={N} bf16, B/C "
          f"broadcast (device time, behind a spin): kernel {k5_ms:.4f} ms, "
          f"plain {k5_plain_ms:.4f} ms, bound {k5_bound_ms:.4f} ms by "
          f"{k5_bound.bound_by}: tensor cores "
          f"{k5_bound.ops_s * 1e3:.4f} ms (C.B^T and dM "
          f"{k5_bound.flops_cb / 1e9:.3f} GFLOP, the f32-operand products "
          f"{k5_bound.flops_f32 / 1e9:.3f} GFLOP twice, hi and lo, over "
          f"{PEAK_BF16_FLOPS / 1e12:g} TFLOP/s bf16), bytes "
          f"{k5_bound.bytes_s * 1e3:.4f} ms ({k5_bound.bytes / 1e6:.2f} MB "
          f"over {HBM_BYTES_PER_S / 1e12:g} TB/s; dB and dC "
          f"{2 * 4 * B * L * H * N / 1e6:.1f} MB of it); the bound with "
          f"the f32-operand products as f32 FMAs on the CUDA cores "
          f"{k5_bound.cuda_core_s * 1e3:.4f} ms; the wrapper's host time to "
          f"queue one call {k5_host_ms:.4f} ms (hidden by the spin); kernel at "
          f"{k5_bound_ms / k5_ms:.1%} of the bound, "
          f"{k5_plain_ms / k5_ms:.2f}x faster than plain; no single PyTorch "
          f"call computes this function")

    # 15.-17. the calibration loop: fit, Fig. 3 tables, O3 sweep, Triad ----
    del x, dt, A, Bm, Cm, args, dy, dstates, dgamma
    gc.collect()
    torch.cuda.empty_cache()
    calibration, fitted_h100 = calibrate_h100(dev)
    # 18. K1 and K2 timing beside their bounds, plain versions, torch calls
    stream_times = time_stream(dev, next(b.path for b in builds
                                         if b.name == "stream"))

    # 19. Fig. 3 at the scale of a model step: the captured steps and
    # prefills simulated against the fitted H100, beside their phases' times
    def plain_prefill_ms(model, n):
        """(kernel ms, host ms) of one n-token prefill on ``model``'s path
        with the serving phases' seeded bf16 weights, after a warm-up."""
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, model.cfg.vocab_size, size=(1, n))).to(dev)

        def prefill():
            model.prefill_fn(params, {"tokens": toks})

        with torch.inference_mode():
            prefill()
            wall = host_seconds(prefill)
            busy, _, _ = kernel_seconds(prefill)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return (busy * 1e3, wall * 1e3) if busy > 0 else (None, None)

    captures = []
    step_sims = fig3_steps(dev, fitted_h100, servings, trainings,
                           plain_prefill_ms, read_launches, captures)

    # 20. the node engine and the simulator's own scan on the card
    node_phase = node_engine(dev, fitted_h100, captures)

    def int8_decode(cfg):
        """Phase 24: prefill one Q8_PROMPT-token prompt through K3, quantize
        its k/v with ``quantize_kv`` into an int8 ``init_cache`` of
        Q8_PROMPT + NEW_TOKENS positions, and run NEW_TOKENS ``decode_fn``
        steps over it; decode the same tokens over a bf16 cache for the
        time and the logits' distance; hold ``decode_attention_q8`` at these
        shapes against naive attention over the dequantized cache in f32;
        print the cache's bytes in int8 and bf16."""
        from repro_torch.models.attention import (decode_attention_q8,
                                                  naive_attention,
                                                  quantize_kv)
        from repro_torch.serve.kvcache import cache_bytes, kv_token_bytes
        arch = cfg.name
        model = build_model(cfg, attn_impl="flash", kv_cache_dtype="int8")
        bf16_model = build_model(cfg, attn_impl="flash")
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in pr.leaves(params))
        print(f"[int8] {arch}: {n_params / 1e9:.3f} B parameters in bf16 "
              f"({cfg.n_layers} of {ARCHS[arch].n_layers} layers), drawn in "
              f"{time.perf_counter() - t0:.1f} s")
        if n_params != cfg.param_count():
            fail(f"{n_params} parameters, config says {cfg.param_count()}")
        smax = Q8_PROMPT + NEW_TOKENS
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(1, Q8_PROMPT))).to(dev)

        def decode(m, cache, first, feed=None):
            """NEW_TOKENS greedy steps from token ``first`` (or the tokens
            ``feed``): (f32 logits of each step, tokens, seconds)."""
            tok, out, toks = first, [], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(NEW_TOKENS):
                if feed is not None:
                    tok = feed[i]
                lg, cache = m.decode_fn(params, cache, {
                    "tokens": tok[:, None], "pos": Q8_PROMPT + i})
                out.append(lg.float())
                tok = lg.argmax(-1)
                toks.append(tok)
            torch.cuda.synchronize()
            return out, toks, time.perf_counter() - t0

        with torch.inference_mode():
            model.prefill_fn(params, {"tokens": prompt[:, :16]})  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, pre = model.prefill_fn(params, {"tokens": prompt})
            cache = model.init_cache(1, smax, device=dev)
            for name in ("k", "v"):
                q8, scale = quantize_kv(pre[name])
                cache[name][:, :, :Q8_PROMPT] = q8
                cache[f"{name}_scale"][:, :, :Q8_PROMPT] = scale
            first = logits.argmax(-1)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            got = read_launches()
            q8_logits, toks, q8_s = decode(model, cache, first)
            peak = torch.cuda.max_memory_allocated()
            want = {"flash_attention": cfg.n_layers, "ssd_scan": 0,
                    "ssd_scan_bwd": 0}
            print(f"[int8] {arch} launches: {got} (want {want})")
            if got != want:
                fail(f"{arch} int8: kernel launches {got}, want {want}")
            tokens = [int(t) for t in toks]
            if not all(0 <= t < cfg.padded_vocab for t in tokens):
                fail(f"{arch} int8: tokens {tokens}")
            # the same tokens over a bf16 cache
            bcache = bf16_model.init_cache(1, smax, device=dev)
            for name in ("k", "v"):
                bcache[name][:, :, :Q8_PROMPT] = pre[name]
            del pre
            bf16_logits, _, bf16_s = decode(bf16_model, bcache, first,
                                            feed=[first] + toks[:-1])
            rel = max(((a - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(q8_logits, bf16_logits))
            same = sum(bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                       for a, b in zip(q8_logits, bf16_logits))
            del q8_logits, bf16_logits

            # decode_attention_q8 at these shapes, first and last layer
            qv = torch.randn((1, 1, cfg.n_heads, cfg.head_dim),
                             generator=fam_gen, device=dev)
            used, err = 0.0, 0.0
            for layer in (0, cfg.n_layers - 1):
                ck, cv, ks, vs = (cache[n][layer] for n in
                                  ("k", "v", "k_scale", "v_scale"))
                got_att = decode_attention_q8(qv, ck, cv, ks, vs, smax)
                want_att = naive_attention(
                    qv, ck.float() * ks.float()[..., None],
                    cv.float() * vs.float()[..., None], causal=False)
                diff = (got_att - want_att).abs()
                err = max(err, diff.max().item())
                used = max(used, (diff / (Q8_TOL + Q8_TOL * want_att.abs()))
                           .max().item())

            # the profiler's view of 8 decode steps over each cache
            def steps(m, c):
                def run():
                    for i in range(8):
                        m.decode_fn(params, c, {"tokens": first[:, None],
                                                "pos": Q8_PROMPT + i})
                return run

            views = {}
            for tag, m, c in (("int8", model, cache),
                              ("bf16", bf16_model, bcache)):
                wall = host_seconds(steps(m, c))
                busy, _, n_kern = kernel_seconds(steps(m, c))
                views[tag] = ("not measured" if busy <= 0 else {
                    "kernels_per_token": n_kern / 8,
                    "kernel_ms_per_token": busy * 1e3 / 8,
                    "host_ms_per_token": wall * 1e3 / 8,
                    "device_idle_share": 1 - busy / wall})
        per_tok = {"int8": kv_token_bytes(model)[0] / cfg.n_layers,
                   "bf16": kv_token_bytes(bf16_model)[0] / cfg.n_layers}
        total = {"int8": cache_bytes(model, 1, smax),
                 "bf16": cache_bytes(bf16_model, 1, smax)}
        print(f"[int8] {arch}: prefill {Q8_PROMPT} tokens {prefill_s * 1e3:.2f}"
              f" ms (K3 and quantize_kv into the int8 cache); decode "
              f"{q8_s * 1e3 / NEW_TOKENS:.2f} ms/token over the int8 cache, "
              f"{bf16_s * 1e3 / NEW_TOKENS:.2f} over bf16 (the same tokens); "
              f"peak memory {peak / 2**30:.3f} GiB; logits int8 vs bf16 "
              f"max|d|/max {rel:.3e}, same argmax {same} of {NEW_TOKENS}; "
              f"cache bytes a token and layer {per_tok['int8']:.0f} int8, "
              f"{per_tok['bf16']:.0f} bf16; whole cache ({smax} positions) "
              f"{total['int8'] / 2**20:.1f} MiB vs {total['bf16'] / 2**20:.1f}"
              f" MiB")
        for tag, v in views.items():
            if isinstance(v, dict):
                print(f"[trace] {arch} decode over the {tag} cache: "
                      f"{v['kernels_per_token']:.0f} kernels and "
                      f"{v['kernel_ms_per_token']:.2f} ms/token of kernel "
                      f"time of {v['host_ms_per_token']:.2f} ms/token on the "
                      f"host clock (device idle {v['device_idle_share']:.1%})")
            else:
                print(f"[trace] {arch} decode over the {tag} cache: the "
                      f"profiler reported no device time: not measured")
        print(f"[check] decode_attention_q8 (B=1 H={cfg.n_heads} "
              f"KVH={cfg.n_kv_heads} D={cfg.head_dim} S={smax}, layers 0 and "
              f"{cfg.n_layers - 1}) vs naive attention over the dequantized "
              f"cache, f32: max|err| {err:.3e}, {used:.1%} of |err| <= "
              f"{Q8_TOL:g} + {Q8_TOL:g}|naive| {'ok' if used <= 1 else 'FAIL'}")
        if used > 1:
            fail("decode_attention_q8 disagrees with attention over the "
                 "dequantized cache")
        del params, cache, bcache
        return {"arch": f"{arch} int8 KV cache", "params": n_params,
                "layers": cfg.n_layers, "prompt_tokens": Q8_PROMPT,
                "new_tokens": NEW_TOKENS, "prefill_ms": prefill_s * 1e3,
                "decode_ms_per_token_int8": q8_s * 1e3 / NEW_TOKENS,
                "decode_ms_per_token_bf16": bf16_s * 1e3 / NEW_TOKENS,
                "peak_mem_bytes": peak, "launches": got, "tokens": tokens,
                "logits_int8_vs_bf16_rel": rel, "same_argmax_steps": same,
                "cache_bytes_per_token_layer": per_tok,
                "cache_bytes": total, "q8_vs_naive_max_abs_err": err,
                "q8_vs_naive_share_of_tolerance": used, "trace": views}

    def fig3_family_prefill(record):
        """Phase 19 for a new family: the longest prompt's prefill on the
        kernel path captured at the phase's width and depth (whisper with
        its 1500-frame encoder), its K3 custom calls held against the
        launches the phase counted a request, simulated against the fitted
        H100 beside the phase's traced prefill."""
        arch = record["arch"]
        cfg = dataclasses.replace(ARCHS[arch], n_layers=record["layers"])
        n = max(record["prompt_tokens"])
        want = {k: v // record["requests"]
                for k, v in record["launches"].items()}
        if want != {"flash_attention": cfg.n_layers + cfg.n_encoder_layers,
                    "ssd_scan": 0, "ssd_scan_bwd": 0}:
            fail(f"{arch}: serving launches {record['launches']}")
        model = build_model(cfg, attn_impl="flash")

        def args():
            batch = {"tokens": torch.zeros((1, n), dtype=torch.long,
                                           device=dev)}
            for name, spec in model.input_specs(
                    ShapeConfig("p", n, 1, "prefill")).items():
                if name != "tokens":
                    batch[name] = torch.empty(spec.shape,
                                              dtype=torch.bfloat16,
                                              device=dev)
            return fake_params(model, torch.bfloat16, dev), batch

        before = read_launches()
        row = capture_and_simulate(
            dev, fitted_h100, f"{arch} ({cfg.n_layers} layers) prefill {n}, "
            f"kernel path", prefill_of(model), args, want,
            traced(record, "prefill_kernel_ms", "prefill_host_ms"), captures)
        if read_launches() != before:
            fail(f"the capture moved the launch counters: {before} -> "
                 f"{read_launches()}")
        return row

    # 21.-24. the audio, vlm and moe families, the int8 KV cache ----------
    def phase_start(label):
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[phase] {label}")
        return time.perf_counter()

    def phase_end(label, t0, record):
        record["phase_s"] = time.perf_counter() - t0
        print(f"[phase] {label}: {record['phase_s']:.1f} s")

    def xcheck_f32(arch, cfg, prompt, extra):
        """Last-position logits through K3 (``flash``) against ``blocked``
        attention, the serving phases' seeded weights drawn in f32 (the
        same draws before their bf16 rounding): summation order only, so
        within XCHECK_F32_TOL of the largest logit (1e-4 held at two layers
        in the CPU tests, test_torch_lm_families.py), and the same
        argmax."""
        model = build_model(cfg, attn_impl="flash")
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.float32)
        batch = {"tokens": torch.tensor([prompt], device=dev),
                 **{k: v.float() for k, v in extra.items()}}
        with torch.inference_mode():
            lf, _ = model.prefill_fn(params, batch)
            lb, _ = build_model(cfg, attn_impl="blocked").prefill_fn(params,
                                                                     batch)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if not (torch.isfinite(lf).all() and torch.isfinite(lb).all()):
            fail(f"{arch}: non-finite logits")
        rel = ((lf - lb).abs().max() / lb.abs().max()).item()
        same_top = bool(torch.equal(lf.argmax(-1), lb.argmax(-1)))
        print(f"[xcheck] {arch} ({cfg.n_layers} layers, f32) "
              f"{len(prompt)}-token prefill, flash vs blocked: "
              f"max|dlogit|/max|logit| {rel:.3e} (tol {XCHECK_F32_TOL:g}); "
              f"same argmax {same_top}")
        if rel > XCHECK_F32_TOL or not same_top:
            fail(f"{arch}: flash and blocked prefill logits differ in f32 "
                 f"by {rel:.3e} (same argmax {same_top})")
        return {"layers": cfg.n_layers, "prompt_tokens": len(prompt),
                "rel_err": rel, "same_argmax": same_top}

    def serve_family(arch, cfg, prompt_lens, extra, xcheck_prompt,
                     xcheck_cfg=None):
        """One family's phase: serving with its K3 launches counted, the
        profiler's view of its longest prompt, and the f32 cross-check."""
        n_k3 = cfg.n_layers + cfg.n_encoder_layers
        record, model, params, engine, prompts = serve_full(
            arch, prompt_lens, NEW_TOKENS,
            {"flash_attention": n_k3 * len(prompt_lens), "ssd_scan": 0,
             "ssd_scan_bwd": 0}, cfg=cfg, extra_inputs=extra)
        record["trace"] = trace_serving(arch, model, params, engine,
                                        prompts[-1], extra_inputs=extra)
        del model, params, engine
        gc.collect()
        torch.cuda.empty_cache()
        record["xcheck"] = xcheck_f32(arch, xcheck_cfg or cfg,
                                      prompts[xcheck_prompt], extra)
        return record

    family_servings = []
    fam_gen = torch.Generator(device=dev).manual_seed(1)
    # 21. whisper-large-v3: 32 encoder layers over 1500 frames (K3, no
    # mask) and 32 decoder layers (K3 causal; cross-attention blocked)
    t_phase = phase_start(f"21 {WHISPER_ARCH}")
    wcfg = ARCHS[WHISPER_ARCH]
    frames = torch.randn((1, wcfg.n_frames, wcfg.d_model), generator=fam_gen,
                         device=dev).bfloat16()
    record = serve_family(WHISPER_ARCH, wcfg, WHISPER_PROMPT_LENS,
                          {"frames": frames}, xcheck_prompt=-1)
    phase_end("21", t_phase, record)
    family_servings.append(record)
    del frames

    # 22. paligemma-3b: 256 image rows, D 256 over one KV head
    t_phase = phase_start(f"22 {VLM_ARCH}")
    vcfg = ARCHS[VLM_ARCH]
    img = torch.randn((1, vcfg.n_img_tokens, vcfg.d_model), generator=fam_gen,
                      device=dev).bfloat16()
    record = serve_family(VLM_ARCH, vcfg, VLM_PROMPT_LENS,
                          {"img_embeds": img}, xcheck_prompt=1)
    phase_end("22", t_phase, record)
    family_servings.append(record)
    del img

    # 23. llama4-scout-17b-a16e: 8 of its 48 layers at full width; the f32
    # cross-check at 2 layers
    t_phase = phase_start(f"23 {MOE_ARCH}")
    mcfg = dataclasses.replace(ARCHS[MOE_ARCH], n_layers=MOE_LAYERS)
    record = serve_family(
        MOE_ARCH, mcfg, PROMPT_LENS, {}, xcheck_prompt=2,
        xcheck_cfg=dataclasses.replace(mcfg, n_layers=MOE_XCHECK_LAYERS))
    record["depth_cut"] = f"{MOE_LAYERS} of {ARCHS[MOE_ARCH].n_layers} layers"
    phase_end("23", t_phase, record)
    family_servings.append(record)

    # 24. the int8 KV cache: qwen1.5-32b, 16 of 64 layers
    t_phase = phase_start(f"24 {Q8_ARCH} int8 KV cache")
    int8_record = int8_decode(dataclasses.replace(ARCHS[Q8_ARCH],
                                                  n_layers=Q8_LAYERS))
    phase_end("24", t_phase, int8_record)

    # 19, continued: the new families' prefills captured and simulated
    for record in family_servings:
        if record["arch"] in (WHISPER_ARCH, MOE_ARCH):
            step_sims.append(fig3_family_prefill(record))
    gc.collect()

    # 25.-27. sampled estimation, the model zoo, the calibration CLIs ------
    sampling = sampled_estimation(dev, captures)
    zoo_phase = model_zoo(dev)
    clis = calibration_clis()

    # 28.-29. hardware DSE and the serving simulator ----------------------
    def check_at(shapes):
        """K3, K4 and K5 against their plain versions at each shape a path
        launched them with: ``{kernel: (max|err|, share of tolerance)}``."""
        helpers = {"flash_attention": compare, "ssd_scan": compare_ssd,
                   "ssd_scan_bwd": compare_ssd_bwd}
        return {name: tuple(map(max, zip(*(helpers[name](*at)
                                           for at in sorted(shapes[name])))))
                for name in KERNELS if shapes[name]}

    dse_phase = dse_on_card(dev, captures)
    serving_phase = serving_on_card(dev, check_at)

    # 30. meshes, the elastic restore, the cluster CLI -----------------------
    mesh_phase = meshes_on_card(dev, check_at)

    # 31.-33. train_lm, the SSD kernel-cost bench, a full-width cell; the
    # cell's captures are host work, in processes beside phases 31-32 -----
    # 34.'s host processes start after phase 31, whose host-bound loop they
    # would slow, and run beside phases 32-33 and the memory check
    import tempfile
    with tempfile.TemporaryDirectory() as cell_tmp:
        procs = start_cell_captures(Path(cell_tmp))
        dry_procs = {}
        try:
            train_lm_phase = train_lm_on_card(dev)
            dry_procs = start_dryrun(Path(cell_tmp))
            ssd_cost_phase = ssd_cost_on_card(dev, check_at)
            cell_phase = cell_on_production_meshes(Path(cell_tmp), procs)
            # 34. the memory analysis, then the dry-run and what reads it
            memory = memory_vs_allocator(dev, step_sims)
            dryrun_record = dryrun_phase(Path(cell_tmp), dry_procs)
            dryrun_record["memory"] = memory
        finally:
            for proc, log, _ in [*procs.values(), *dry_procs.values()]:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()

    if failures:
        fail("; ".join(failures))
    scan_row = next(r for r in node_phase["kernel_vs_plain"]
                    if r["case"] == f"J2 shard {SCAN_STEP}")
    for record in servings + family_servings:
        print(json.dumps({"serving": record}))
    print(json.dumps({"int8_kv_cache": int8_record}))
    for record in trainings:
        print(json.dumps({"training": record}))
    print(json.dumps({"calibration": calibration}))
    print(json.dumps({"fig3_steps": step_sims}))
    print(json.dumps({"node_engine": node_phase}))
    print(json.dumps({"sampled_estimation": sampling}))
    print(json.dumps({"model_zoo": zoo_phase}))
    print(json.dumps({"calibration_clis": clis}))
    print(json.dumps({"dse": dse_phase}))
    print(json.dumps({"serving_simulator": serving_phase}))
    print(json.dumps({"meshes": mesh_phase}))
    print(json.dumps({"train_lm": train_lm_phase}))
    print(json.dumps({"ssd_kernel_cost": ssd_cost_phase}))
    print(json.dumps({"cell_capture": cell_phase}))
    print(json.dumps({"dryrun": dryrun_record}))
    by_path = {k: {r["arch"]: r["launches"][k] for r in
                   servings + trainings + family_servings + [int8_record]}
               for k in KERNELS}
    for k in KERNELS:
        by_path[k]["serve_lm example"] = serving_phase["launches"][k]
        by_path[k]["phase 30 (mesh)"] = mesh_phase["launches"][k]
        by_path[k]["phase 31 (train_lm)"] = train_lm_phase["launches"][k]
    for k, v in ssd_cost_phase["launches"].items():
        by_path[k]["phase 32 (ssd_kernel_cost)"] = v
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
        "ms": k4_times[0]["ms"], "kernel_ms": k4_times[0]["ms"],
        "plain_ms": k4_times[0]["plain_ms"],
        "timing": "device time: the median of calls each behind a "
                  "device-side spin",
        "bound_ms": k4_times[0]["bound_ms"],
        "bound_by": k4_times[0]["bound_by"],
        "library_ms": None,
        "shape": k4_times[0]["shape"], "by_shape": k4_times}, {
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
        "bound_by": k5_bound.bound_by,
        "timing": "device time: the median of calls each behind a "
                  "device-side spin",
        "library_ms": None,
        "shape": f"B={B} nc={nc} Q={Q} H={H} P={P} N={N} bf16, B/C "
                 f"broadcast"}, {
        "name": "stream_elementwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stream.cu",
        "replaces": "src/repro/kernels/stream.py:74",
        "launches": calibration["launches"]["stream_elementwise"]
        + clis["launches"]["stream_elementwise"],
        "launches_by_path": {"calibration": calibration["launches"][
            "stream_elementwise"], "calibration CLIs": clis["launches"][
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
        "launches": calibration["launches"]["stream_triad"]
        + clis["launches"]["stream_triad"],
        "launches_by_path": {"calibration": calibration["launches"][
            "stream_triad"], "calibration CLIs": clis["launches"][
            "stream_triad"]},
        "max_abs_err": max(stream_checks["k2_err"], stream_times["k2_err"]),
        "tolerance": "f32 |err| <= 1e-6 + 1e-5|plain|, f64 1e-12 + "
                     "1e-12|plain|",
        "share_of_tolerance": max(stream_checks["k2_used"],
                                  stream_times["k2_used"]),
        **stream_times["k2"]}, {
        "name": "sched_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sched_scan.cu",
        "replaces": "src/repro/core/compiled.py:412",
        "also_replaces": "src/repro/core/node.py:940",
        "launches": node_phase["launches"] + sampling["launches"]
        + zoo_phase["launches"] + dse_phase["launches"],
        "launches_by_path": {**{r["case"]: r["launches"]
                                for r in node_phase["cases"]},
                             "sampled estimation": sampling["launches"],
                             "model zoo": zoo_phase["launches"],
                             "dse": dse_phase["launches"]},
        "max_abs_err": 0.0,
        "tolerance": "bit-identical to the plain version and to the NumPy "
                     "pass (0 elements differ)",
        "ms": scan_row["ms"], "plain_ms": scan_row["plain_ms"],
        "bound_ms": scan_row["bound_ms"], "bound_by": scan_row["bound_by"],
        "timing": "device time: CUDA events around 5 calls after a warm-up; "
                  "plain: host clock of one call on the card",
        "library_ms": None,
        "shape": scan_row["case"] + f", {scan_row['n_ops']} ops, "
                 f"{scan_row['elements']} elements",
        "by_case": node_phase["kernel_vs_plain"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
