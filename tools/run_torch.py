"""Benchmark entry point of the port: one run per paper table or figure.
Counterpart of ``benchmarks/run.py``.

    PYTHONPATH=src python3 tools/run_torch.py [--quick] [--skip-triad]
        [--device cpu] [--out-dir experiments/bench_torch]

* ``kernel_suite_torch`` -- Table 1 + Fig. 3 (K1 on the card: the 28
  kernels measured against the simulator on the fitted ``H100``),
* ``triad_torch`` -- Figs. 4/5 (K2's STREAM Triad over CTA caps, two
  sizes),
* ``roofline_table_torch`` -- the §Roofline table of the port's dry-run
  artifacts, if present.

Runs on the card unless ``--device cpu`` (the plain K1 and K2 functions;
the tests' mode) and raises without one.  Each CLI's JSON goes to
``--out-dir`` (``kernel_suite.json``, ``triad.json``), never over the
committed ``BENCH_*_h100.json``.  Prints a final ``name,us_per_call,
derived`` CSV, the reference's.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import kernel_suite_torch  # noqa: E402
import roofline_table_torch  # noqa: E402
import triad_torch  # noqa: E402

OUT = Path("experiments/bench_torch")


def csv_rows(out_dir: Path) -> list:
    """The ``name,us_per_call,derived`` rows of the JSON in ``out_dir``."""
    rows = []
    ks = out_dir / "kernel_suite.json"
    if ks.exists():
        d = json.loads(ks.read_text())
        for name, k in d["kernels"].items():
            diff = 100.0 * (k["t_est_occupancy_us"] - k["measured_us"]) \
                / k["measured_us"]
            rows.append(f"kernel.{name},{k['measured_us']:.2f},"
                        f"diff_pct={diff:.1f}")
        s = d["summary"]
        rows.append(f"kernel_suite.mean_abs_diff,,"
                    f"{s['mean_abs_diff_pct']:.2f}pct_vs_paper_"
                    f"{s['paper']['mean_abs_diff_pct']}pct")
        rows.append(f"kernel_suite.within_10pct,,"
                    f"{100 * s['within_10pct']:.0f}pct_vs_paper_82pct")
    tr = out_dir / "triad.json"
    if tr.exists():
        d = json.loads(tr.read_text())
        for section in ("triad_l2", "triad_mem"):
            for row in d[section]:
                rows.append(f"{section}.t{row['ctas']},"
                            f"{row['measured_s'] * 1e6:.1f},"
                            f"gbps={row['measured_gbps']:.2f};"
                            f"diff_pct={row['diff_pct']:.1f}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip-triad", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (K1 and K2 on the card; raises without one) "
                         "or cpu (their plain versions)")
    ap.add_argument("--out-dir", type=Path, default=OUT)
    args = ap.parse_args(argv)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    common = (["--quick"] if args.quick else []) + ["--device", args.device]

    rc = 0
    print("#" * 72)
    print("# kernel_suite_torch (paper Table 1 + Fig. 3)")
    print("#" * 72)
    rc |= kernel_suite_torch.main(
        common + ["--out", str(args.out_dir / "kernel_suite.json")])

    if not args.skip_triad:
        print("\n" + "#" * 72)
        print("# triad_torch (paper Figs. 4/5)")
        print("#" * 72)
        rc |= triad_torch.main(
            common + ["--out", str(args.out_dir / "triad.json")])

    print("\n" + "#" * 72)
    print("# roofline table (from the port's dry-run artifacts)")
    print("#" * 72)
    roofline_table_torch.main([])    # informative; absent artifacts -> note

    print("\nname,us_per_call,derived")
    for row in csv_rows(args.out_dir):
        print(row)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
