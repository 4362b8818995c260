"""The paper's workflow on the port, end to end: estimate a full-scale
application's execution profile on hardware you don't have.  Counterpart
of ``examples/simulate_app.py``.

    PYTHONPATH=src python examples/simulate_app_torch.py --arch grok-1-314b \\
        --shape train_4k [--multi-pod]

Captures the FULL-size architecture for the production 256-rank mesh
(512 with ``--multi-pod``: torch's fake process group, fake tensors, no
allocation and no card) through the dry-run's ``run_cell(...,
force=True)``, then prints the simulator's PA report on the ``H100`` spec
(roofline terms, bound-by classification, collective schedule, tuning
hints), the capture's memory analysis a rank in GiB and whether it fits
the H100's 80 GB.  ``--reduced --mesh DxM`` takes the reduced widths on a
(data, model) mesh of D x M fake ranks (for tests).

Runs in a process of its own: the fake group's world size is fixed once a
process.
"""
import argparse
import os
import subprocess
import sys

CHILD = r"""
import json
from pathlib import Path
from repro_torch.launch.dryrun import run_cell
r = run_cell({arch!r}, {shape!r}, multi_pod={multi}, force=True,
             out_dir=Path({out!r}), reduced={reduced},
             mesh_shape={mesh_shape})
print(r["pa_report"])
mem = r.get("memory_analysis") or {{}}
print()
print("memory_analysis per rank:",
      {{k: f"{{v/2**30:.2f}} GiB" for k, v in mem.items()}})
print(f"fits the H100's {{r['hbm_per_chip'] / 1e9:.0f}} GB:", r["fits_hbm"])
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="grok-1-314b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DxM: a (data, model) mesh (for tests)")
    args = ap.parse_args(argv)
    mesh_shape = ([int(x) for x in args.mesh.split("x")] if args.mesh
                  else None)
    code = CHILD.format(arch=args.arch, shape=args.shape,
                        multi=args.multi_pod, out=args.out,
                        reduced=args.reduced, mesh_shape=mesh_shape)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(root, "src")
    sys.stdout.flush()
    return subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=root).returncode


if __name__ == "__main__":
    raise SystemExit(main())
