"""Time one-change variants of the K1 and K3 CUDA sources against the
committed sources on the card.

    python3 tools/kernel_variants.py

Each variant is the committed source with one textual change (VARIANTS
below; the script fails if a change no longer applies), built by ``nvcc``
with the port's flags beside the committed library.  Every variant's output
is held to the committed kernel's (K1: bit for bit; K3: both within 2e-2 +
2e-2|plain| of the plain version), then both are timed in turns (committed,
variant, variant, committed) in one process, each call behind a device-side
spin as ``core/calibrate.py``'s ``_median_time`` times it.  K3 at
chatglm3-6b's and zamba2-1.2b's attention (S = 2048, causal, (B, S, H, D)
views); K1 on the 28 Table-1 expressions at Table 1's n x 16384.  Needs a
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
}


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
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
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
    libs = {"flash_attention": _build.load("flash_attention").lib,
            "stream": _build.load("stream").lib}
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

    def in_turns(run_a, run_b):
        """(a ms, b ms): medians timed a, b, b, a; each the mean of its two."""
        a1, b1, b2, a2 = (cal._median_time(run, on_card, REPEATS)
                          for run in (run_a, run_b, run_b, run_a))
        return (a1 + a2) / 2 * 1e3, (b1 + b2) / 2 * 1e3

    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (source, changes, what) in VARIANTS.items():
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
