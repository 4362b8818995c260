"""Time one-change variants of the K1, K2, K3, K4 and K5 CUDA sources
against the committed sources on the card.

    python3 tools/kernel_variants.py            # every variant
    python3 tools/kernel_variants.py k4 k5      # those whose names start so

Each variant is the committed source with one textual change (VARIANTS
below; the script fails if a change no longer applies), built by ``nvcc``
with the port's flags beside the committed library.  Every variant's output
is held to the committed kernel's (K1: bit for bit; K3: both within 2e-2 +
2e-2|plain| of the plain version), then both are timed in turns (committed,
variant, variant, committed) in one process, each call behind a device-side
spin as ``core/calibrate.py``'s ``_median_time`` times it.  K3 at
chatglm3-6b's and zamba2-1.2b's attention (S = 2048, causal, (B, S, H, D)
views); K1 on the 28 Table-1 expressions at Table 1's n x 16384; K2 (bit for
bit) in f64 at twice the L2 (2^22 elements), about 3/4 of it (184 x 8192)
and 2^26 elements (1.6 GB) at every CTA cap of the Figs. 4/5 sweep and the full grid, beside
``torch.add(a, b, alpha=3)``, each cap timed both behind a spin and by
one replay of a CUDA graph of 20 launches (as the Figs. 4/5 sweep times
it); K4 (bit for bit, or within its tolerance of the plain version where
the variant changes the arithmetic) at mamba2-1.3b's prefill and training
shapes and zamba2-1.2b's prefill shape (B 1 or 4, nc 8, Q 256, H 64, P 64,
N 128 or 64, bf16, B/C broadcast); K5 (bit for bit) at mamba2-1.3b's training
shape (B 4, nc 8, Q 256, H 64, P 64, N 128, bf16, B/C broadcast).  Needs a
CUDA card; exits 1 without one.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "kernel_variants"
REPEATS = 20
FLASH_SHAPES = [("chatglm3-6b", 32, 2, 128, 2048), ("zamba2-1.2b", 32, 32, 64, 2048)]

# name -> (source, [(old text, new text)], what the change does)
VARIANTS = {
    "k3_two_stages": ("flash_attention", [(
        "template <> struct HopperTile<128> { static constexpr int BK = 128, ST = 3; };",
        "template <> struct HopperTile<128> { static constexpr int BK = 128, ST = 2; };")],
        "2 stages instead of 3 at D = 128"),
    "k3_no_overlap": ("flash_attention", [(
        "wgmma_wait<1>();  // S(kt) is done, P V(kt - 1) may still run",
        "wgmma_wait<0>();  // S(kt) and P V(kt - 1) are done")],
        "the softmax of block j waits for P.V(j-1) too: no softmax/P.V overlap"),
    "k1_capped_grid": ("stream", [(
        "    const int grid = static_cast<int>(std::max(tiles, 1LL));\n"
        "    ew_vec_kernel",
        "    static int per_sm = 0;\n"
        "    const int grid = fill_grid(ew_vec_kernel<E, Tin, Tout>, per_sm, tiles * kEwThreads);\n"
        "    ew_vec_kernel")],
        "vector path: a grid capped at the blocks that fit at once, striding over the tiles"),
    "k1_eight_a_thread": ("stream", [(
        "constexpr int kEwUnroll = 4;", "constexpr int kEwUnroll = 8;")],
        "8 elements a thread a tile instead of 4"),
    "k1_128_threads": ("stream", [(
        "constexpr int kEwThreads = 256;", "constexpr int kEwThreads = 128;")],
        "128-thread blocks instead of 256"),
    "k2_scalar": ("stream", [(
        "const bool vec = aligned16(a) && aligned16(b) && aligned16(y);",
        "const bool vec = false;")],
        "K2's scalar path only: one element a thread, a grid-stride loop, two CTAs an SM"),
    "k2_eight_a_thread": ("stream", [(
        "constexpr int kTriadUnroll = 4;", "constexpr int kTriadUnroll = 8;")],
        "K2 with 8 elements a thread a tile instead of 4"),
    "k2_tile_a_block": ("stream", [(
        "      grid = tiles >= 2 * resident ? tiles : std::min(tiles, resident);",
        "      grid = tiles;")],
        "K2's vector path without a cap: one CTA a tile at every size"),
    "k2_resident_grid": ("stream", [(
        "      grid = tiles >= 2 * resident ? tiles : std::min(tiles, resident);",
        "      grid = std::min(tiles, resident);")],
        "K2's vector path without a cap: the CTAs that fit at once, striding, at every size"),
    "k2_l2_prefetch": ("stream", [(
        "      load_piece<P>(av + k * P, a + e);\n      load_piece<P>(bv + k * P, b + e);\n",
        "      if constexpr (sizeof(T) == 8) {\n"
        "        asm(\"ld.global.L2::256B.v2.f64 {%0, %1}, [%2];\" : \"=d\"(av[k * P]),"
        " \"=d\"(av[k * P + 1]) : \"l\"(a + e));\n"
        "        asm(\"ld.global.L2::256B.v2.f64 {%0, %1}, [%2];\" : \"=d\"(bv[k * P]),"
        " \"=d\"(bv[k * P + 1]) : \"l\"(b + e));\n"
        "      } else {\n"
        "        load_piece<P>(av + k * P, a + e);\n        load_piece<P>(bv + k * P, b + e);\n"
        "      }\n")],
        "K2's f64 vector loads with a 256-byte L2 prefetch hint"),
    "k2_streaming": ("stream", [(
        "      load_piece<P>(av + k * P, a + e);\n      load_piece<P>(bv + k * P, b + e);\n",
        "      if constexpr (sizeof(T) == 8) {\n"
        "        const double2 va = __ldcs(reinterpret_cast<const double2*>(a + e));\n"
        "        const double2 vb = __ldcs(reinterpret_cast<const double2*>(b + e));\n"
        "        av[k * P] = va.x; av[k * P + 1] = va.y; bv[k * P] = vb.x; bv[k * P + 1] = vb.y;\n"
        "      } else {\n"
        "        load_piece<P>(av + k * P, a + e);\n        load_piece<P>(bv + k * P, b + e);\n"
        "      }\n"), (
        "      store_piece(y + e0 + static_cast<long long>(k) * kTriadThreads * P, r + k * P);",
        "      if constexpr (sizeof(T) == 8)\n"
        "        __stcs(reinterpret_cast<double2*>(y + e0 + static_cast<long long>(k) *"
        " kTriadThreads * P), make_double2(r[k * P], r[k * P + 1]));\n"
        "      else\n"
        "        store_piece(y + e0 + static_cast<long long>(k) * kTriadThreads * P, r + k * P);")],
        "K2's f64 vector loads and stores with the evict-first (streaming) cache hint"),
    "k4_three_stages": ("ssd_scan", [(
        "static constexpr int XST = 4;", "static constexpr int XST = 3;")],
        "x tiles in 3 stages a warpgroup instead of 4: two tiles load ahead, not three"),
    "k4_no_overlap": ("ssd_scan", [
        ("    wgmma_commit();\n    if (nxt.u < steps) form_m(nxt);",
         "    wgmma_commit();\n    wgmma_wait<0>();\n    if (nxt.u < steps) form_m(nxt);"),
        ("    wgmma_commit();\n    Walk nxt = cur;",
         "    wgmma_commit();\n    wgmma_wait<0>();\n    Walk nxt = cur;")],
        "each M x (B^T w x) product waited for at once: forming the next M (w x) does not "
        "overlap it"),
    "k4_heads4": ("ssd_scan", [(
        "constexpr int kHeads = 8;", "constexpr int kHeads = 4;")],
        "4 heads a CTA instead of 8: twice the CTAs, C.B^T formed twice as often"),
    "k4_heads16": ("ssd_scan", [
        ("constexpr int kHeads = 8;", "constexpr int kHeads = 16;"),
        ("static constexpr int XST = 4;", "static constexpr int XST = 3;")],
        "16 heads a CTA instead of 8 (3 x stages, for the shared memory): half the CTAs, "
        "C.B^T formed half as often"),
    "k4_s_per_head": ("ssd_scan", [(
        "p.shared = H == 1 || (p.b_s[3] == 0 && p.c_s[3] == 0);", "p.shared = H == 1;")],
        "B/C shared by the heads taken as per-head: C.B^T (and B's columns) for each head, "
        "one warpgroup running"),
    "k4_no_factor": ("ssd_scan", [(
        "if (jt < it && i0 + kTile <= Q && falls[hl]) {", "if (false) {")],
        "exp(cs_i - cs_j) for every entry, not a_i b_j below the diagonal tile"),
    "k4_no_bulk": ("ssd_scan", [(
        "  if (aligned && stride == cols && cols * sizeof(T) == kRow) {", "  if (false) {")],
        "the states leave as 16-byte row pieces from every thread, as y does, not by one "
        "bulk copy"),
    "k4_four_s_tiles": ("ssd_scan", [(
        "const int jn = one_batch ? it + 1 : 4;", "const int jn = 4;")],
        "every row CTA forms 4 tiles of C.B^T (those past its tile it on tile 0, not "
        "stored), not it + 1"),
    "k5_one_stage": ("ssd_scan_bwd", [(
        "static constexpr int STAGES = kSplit ? 1 : 2;",
        "static constexpr int STAGES = 1;")],
        "bf16 tiles loaded one stage at a time: no load overlaps the products"),
}
TRIAD_NS = (1 << 22, 184 * 8192, 1 << 26)
TRIAD_CAPS = (1, 2, 4, 8, 16, 33, 66, 132, None)


def build_variant(name: str, source: str, changes) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    text = (_build.CSRC / f"{source}.cu").read_text()
    for old, new in changes:
        if text.count(old) != 1:
            raise SystemExit(f"kernel_variants: {name}: the change no longer applies")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"kernel_variants: {name} failed to build:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    for fn, (restype, argtypes) in _build.SIGNATURES[source].items():
        getattr(dll, fn).restype, getattr(dll, fn).argtypes = restype, argtypes
    return dll


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.a64fx_kernelsuite import KERNELS as SUITE
    from repro_torch.core import calibrate as cal
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stream

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    wanted = [name for name in VARIANTS
              if not sys.argv[1:] or any(name.startswith(a) for a in sys.argv[1:])]
    libs = {source: _build.load(source).lib for source in {VARIANTS[n][0] for n in wanted}}
    stream_t = torch.cuda.current_stream(dev).cuda_stream

    def flash(lib, q, k, v):
        B, H, Sq, D = q.shape
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
        strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, D, B, H, k.shape[1],
            Sq, k.shape[2], strides, 1.0 / math.sqrt(D), 1, stream_t)
        if err:
            raise RuntimeError(f"flash attention launch failed ({err})")
        return out

    ids = {n: i for i, n in enumerate([*stream.EXPRS, *stream.FIT_EXPRS])}

    def elementwise(lib, name, x1, x2, y0, y):
        err = lib.repro_stream_elementwise(ids[name], 0, x1.data_ptr(), x2.data_ptr(),
                                           y0.data_ptr(), y.data_ptr(), y.numel(), stream_t)
        if err:
            raise RuntimeError(f"elementwise launch failed ({err})")
        return y

    on_card = (torch.zeros(1, device=dev),)  # _median_time reads the device off args[0]

    def in_turns(run_a, run_b, timer=cal._median_time):
        """(a ms, b ms): timed a, b, b, a; each the mean of its two.  The
        timer: the median behind a spin, or one replay of a CUDA graph of
        REPEATS calls (as ``calibrate.triad_scaling`` times K2)."""
        a1, b1, b2, a2 = (timer(run, on_card, REPEATS)
                          for run in (run_a, run_b, run_b, run_a))
        return (a1 + a2) / 2 * 1e3, (b1 + b2) / 2 * 1e3

    def triad(lib, a, b, y, cap):   # on the current stream: graph capture uses its own
        err = lib.repro_stream_triad(0, a.data_ptr(), b.data_ptr(), 3.0, y.data_ptr(),
                                     y.numel(), cap or 0,
                                     torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"triad launch failed ({err})")
        return y

    def ssd_fwd(lib, args, outs):
        x, dt, A, Bm, Cm = args
        B, nc, Q, H, P = x.shape
        strides = (ctypes.c_longlong * 16)(*(s for t in (x, dt, Bm, Cm) for s in t.stride()[:4]))
        err = lib.repro_ssd_chunk_fwd(*(t.data_ptr() for t in (*args, *outs)), 1, B, nc, Q, H, P,
                                      Bm.shape[-1], strides, stream_t)
        if err:
            raise RuntimeError(f"ssd_chunk launch failed ({err})")
        return outs

    def ssd_bwd(lib, args, outs, scratch):
        x, dt, A, Bm, Cm, dy, ds, dg = args
        B, nc, Q, H, P = x.shape
        strides = (ctypes.c_longlong * 20)(
            *(s for t in (x, dt, Bm, Cm, dy) for s in t.stride()[:4]))
        err = lib.repro_ssd_chunk_bwd(*(t.data_ptr() for t in (*args, *outs, scratch)), 1, B, nc,
                                      Q, H, P, Bm.shape[-1], strides, stream_t)
        if err:
            raise RuntimeError(f"ssd_chunk_bwd launch failed ({err})")
        return outs

    gen = torch.Generator(device=dev).manual_seed(0)
    for name in wanted:
        source, changes, what = VARIANTS[name]
        var = build_variant(name, source, changes)
        print(f"[variant] {name}: {what}")
        base = libs[source]
        if source == "flash_attention":
            for label, H, KVH, D, S in FLASH_SHAPES:
                q, k, v = (torch.randn((1, S, n, D), generator=gen, device=dev)
                           .bfloat16().transpose(1, 2) for n in (H, KVH, KVH))
                want = fa.flash_attention_plain(q, k, v, causal=True).float()
                for lib in (base, var):
                    got = flash(lib, q, k, v).float()
                    used = ((got - want).abs() / (2e-2 + 2e-2 * want.abs())).max().item()
                    if used > 1:
                        raise SystemExit(f"kernel_variants: {name} disagrees at {label}")
                a, b = in_turns(lambda _: flash(base, q, k, v), lambda _: flash(var, q, k, v))
                print(f"[variant] {name} {label} H={H} KVH={KVH} D={D} S={S}: committed "
                      f"{a:.4f} ms, variant {b:.4f} ms ({b / a - 1:+.1%})")
        elif name.startswith("k2"):
            for n in TRIAD_NS:
                a, b = (torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
                        for _ in range(2))
                y = torch.empty_like(a)
                want = stream.stream_triad_plain(a, b, 3.0)
                t_add, t_plain = (cal._median_time(fn, on_card, REPEATS) * 1e3 for fn in (
                    lambda _: torch.add(a, b, alpha=3.0),
                    lambda _: stream.stream_triad_plain(a, b, 3.0)))
                print(f"[variant] {name} n={n} f64: torch.add(a, b, alpha=3) {t_add:.5f} ms, "
                      f"plain {t_plain:.5f} ms")
                for cap in TRIAD_CAPS:
                    for lib in (base, var):
                        if not torch.equal(triad(lib, a, b, y, cap), want):
                            raise SystemExit(f"kernel_variants: {name} differs at {n}, {cap}")
                    gbs = 24 * n / 1e6
                    for how, timer in (("spin", cal._median_time), ("graph", cal._graph_time)):
                        ta, tb = in_turns(lambda _: triad(base, a, b, y, cap),
                                          lambda _: triad(var, a, b, y, cap), timer)
                        print(f"[variant] {name} n={n} max_ctas={cap} ({how}): committed "
                              f"{ta:.5f} ms ({gbs / ta:.0f} GB/s), variant {tb:.5f} ms "
                              f"({gbs / tb:.0f} GB/s) ({tb / ta - 1:+.1%})")
                del a, b, y, want
        elif name.startswith("k4"):
            from repro_torch.kernels import ssd_scan as ssd
            for label, B, N in (("mamba2-1.3b prefill", 1, 128), ("mamba2-1.3b training", 4, 128),
                                ("zamba2-1.2b prefill", 1, 64)):
                nc, Q, H, P = 8, 256, 64, 64
                x = torch.randn((B, nc, Q, H, P), generator=gen, device=dev).bfloat16()
                dt = torch.nn.functional.softplus(torch.randn((B, nc, Q, H), generator=gen,
                                                              device=dev)).bfloat16()
                A = -torch.exp(0.5 * torch.randn(H, generator=gen, device=dev))
                Bm, Cm = ((0.5 * torch.randn((B, nc, Q, 1, N), generator=gen, device=dev))
                          .bfloat16().expand(B, nc, Q, H, N) for _ in range(2))
                args = (x, dt, A, Bm, Cm)
                want = ssd.ssd_chunk(*args)
                plain = ssd.ssd_chunk_plain(*args)
                outs = tuple(torch.empty_like(t) for t in want)
                for lib in (base, var):
                    got = ssd_fwd(lib, args, outs)
                    if name == "k4_no_factor":   # other arithmetic: K4's tolerance
                        for g, w, tol in zip(got, plain, (2e-2, 1e-3, 1e-3)):
                            if ((g.float() - w.float()).abs()
                                    > tol + tol * w.float().abs()).any():
                                raise SystemExit(f"kernel_variants: {name} disagrees with plain")
                    elif not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise SystemExit(f"kernel_variants: {name} differs from ssd_chunk")
                ta, tb = in_turns(lambda _: ssd_fwd(base, args, outs),
                                  lambda _: ssd_fwd(var, args, outs))
                print(f"[variant] {name} {label} B={B} nc={nc} Q={Q} H={H} P={P} N={N} bf16 "
                      f"broadcast: committed {ta:.4f} ms, variant {tb:.4f} ms ({tb / ta - 1:+.1%})")
                del x, dt, Bm, Cm, args, want, plain, outs
        elif name.startswith("k5"):
            from repro_torch.kernels import ssd_scan as ssd
            B, nc, Q, H, P, N = 4, 8, 256, 64, 64, 128
            x, dy = (torch.randn((B, nc, Q, H, P), generator=gen, device=dev).bfloat16()
                     for _ in range(2))
            dt = torch.nn.functional.softplus(torch.randn((B, nc, Q, H), generator=gen,
                                                          device=dev)).bfloat16()
            A = -torch.exp(0.5 * torch.randn(H, generator=gen, device=dev))
            Bm, Cm = ((0.5 * torch.randn((B, nc, Q, 1, N), generator=gen, device=dev))
                      .bfloat16().expand(B, nc, Q, H, N) for _ in range(2))
            args = (x, dt, A, Bm, Cm, dy,
                    torch.randn((B, nc, H, N, P), generator=gen, device=dev),
                    torch.randn((B, nc, H), generator=gen, device=dev))
            want = ssd.ssd_chunk_bwd(*args)
            outs = tuple(torch.empty_like(t) for t in want)
            scratch = torch.empty((B * nc * H, 3 + Q // 64, Q), dtype=torch.float64, device=dev)
            for lib in (base, var):
                got = ssd_bwd(lib, args, outs, scratch)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise SystemExit(f"kernel_variants: {name} differs from ssd_chunk_bwd")
            ta, tb = in_turns(lambda _: ssd_bwd(base, args, outs, scratch),
                              lambda _: ssd_bwd(var, args, outs, scratch))
            print(f"[variant] {name} B={B} nc={nc} Q={Q} H={H} P={P} N={N} bf16 broadcast: "
                  f"committed {ta:.4f} ms, variant {tb:.4f} ms ({tb / ta - 1:+.1%})")
        else:
            tot_a = tot_b = 0.0
            for kern in SUITE:
                n = kern.n * 16384
                x1, x2, y0 = cal._kernel_inputs(kern, n, gen, dev)
                y = torch.empty(n, dtype=stream.DTYPES[stream.EXPRS[kern.name][3]], device=dev)
                ref = elementwise(base, kern.name, x1, x2, y0, y).clone()
                if not torch.equal(elementwise(var, kern.name, x1, x2, y0, y), ref):
                    raise SystemExit(f"kernel_variants: {name} differs on {kern.name}")
                a, b = in_turns(lambda _: elementwise(base, kern.name, x1, x2, y0, y),
                                lambda _: elementwise(var, kern.name, x1, x2, y0, y))
                tot_a, tot_b = tot_a + a, tot_b + b
                print(f"[variant] {name} {kern.name:<6s} n={n}: committed {a * 1e3:.1f} us, "
                      f"variant {b * 1e3:.1f} us ({b / a - 1:+.1%})")
                del x1, x2, y0, y, ref
            print(f"[variant] {name}: the 28 summed: committed {tot_a:.3f} ms, variant "
                  f"{tot_b:.3f} ms ({tot_b / tot_a - 1:+.1%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
