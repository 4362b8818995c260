"""Paper Figs. 4 & 5 on the port: STREAM Triad (K2) scaling, simulator vs
measured.

    PYTHONPATH=src python3 tools/triad_torch.py [--quick] [--device cpu]

The port's counterpart of ``benchmarks/triad.py``, which sweeps host
threads; here ``calibrate.triad_scaling`` sweeps the number of CTAs K2 may
use (one 1024-thread CTA per SM up to the cap) and fits the same
saturating-bandwidth model, ``t_sim = bytes / min(k * bw1, plateau)``
(``calibrate.triad_fit``), at two sizes as in the paper:

* ``triad_l2``: about 3/4 of the H100's 50 MB L2 (Fig. 4),
* ``triad_mem``: twice the L2, HBM-resident (Fig. 5).

On the card each time is the device time of ``repeats`` K2 launches
replayed from a CUDA graph; under ``--device cpu`` K2's plain version on
the host clock, where the CTA cap does not apply.  Writes ``--out``
(default ``BENCH_triad_h100.json``): the fits, the rows of each size and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.core import calibrate  # noqa: E402
from sched_throughput_torch import card  # noqa: E402

BENCH_JSON = Path("BENCH_triad_h100.json")
# f64 elements: 3 arrays of ~12 MB (about 3/4 of the L2) and of 32 MB
L2_ELEMS, MEM_ELEMS = 184 * 8192, 1 << 22
CTAS = (1, 2, 4, 8, 16, 33, 66, 132)
QUICK_CTAS = (1, 4, 16, 132)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help=f"CTA caps {QUICK_CTAS}, 7 repeats")
    ap.add_argument("--device", default="cuda",
                    help="cuda (K2 on the card; raises without one) or cpu "
                         "(its plain version)")
    ap.add_argument("--out", type=Path, default=BENCH_JSON)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.device import resolve
    device = resolve(args.device)
    ctas = QUICK_CTAS if args.quick else CTAS
    repeats = 7 if args.quick else calibrate.REPEATS

    out = {"card": card() if device.type == "cuda" else "cpu",
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "repeats": repeats, "calibration": {}}
    for name, n in (("triad_l2", L2_ELEMS), ("triad_mem", MEM_ELEMS)):
        rows, fit = calibrate.triad_scaling(n, ctas, repeats, device)
        nbytes = 3 * 8 * n
        print(f"== {name}: {nbytes / 2**20:.0f} MiB working set (fit: bw1 "
              f"{fit['bw1'] / 1e9:.2f} GB/s, plateau "
              f"{fit['plateau'] / 1e9:.2f} GB/s) ==")
        print(f"{'ctas':>8s}{'measured_GB/s':>15s}{'simulated_GB/s':>16s}"
              f"{'diff%':>8s}")
        for r in rows:
            print(f"{r['ctas']:>8d}{r['measured_gbps']:>15.2f}"
                  f"{r['simulated_gbps']:>16.2f}{r['diff_pct']:>8.1f}")
        out["calibration"][name.split("_")[1]] = fit
        out[name] = [{"n": n, **r} for r in rows]
    args.out.write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
