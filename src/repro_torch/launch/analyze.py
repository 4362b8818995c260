"""PA-data deep-dive for one cell: top ops by modelled time and bytes,
trip counts, the memory analysis -- the RIKEN simulator's per-section
profiling applied to a captured (arch x shape x mesh) cell.  Counterpart
of ``repro.launch.analyze``.

    PYTHONPATH=src python -m repro_torch.launch.analyze --arch chatglm3-6b \\
        --shape decode_32k [--multi-pod] [--dump-graph /tmp/x.py]

The cell is the dry-run's (``launch.dryrun.capture``: the full-width
cell on the fake production mesh, captured by ``Cell.capture``), in a
process of its own for torch's fake process group.  Prints the PA report
of ``simulate`` on the ``H100`` spec, the capture's
``core.aten.memory_analysis``, the top ops by modelled time in the
reference's columns, and the op-count histogram.  ``--dump-graph``
writes the capture's code (``gm.code``) where the reference writes its
HLO.  ``--reduced --mesh-shape DxM`` take the reduced widths on a (data,
model) mesh (for tests).  Host code: nothing runs on a card.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys

from ..configs import SHAPES
from ..core import aten
from ..core.hwspec import H100
from ..core.simulate import simulate
from .cell import model_flops_for
from .dryrun import SRC, capture


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dump-graph", default=None)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh-shape", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def analyze(args) -> int:
    run_overrides = {}
    if args.microbatch is not None:
        run_overrides["microbatch"] = args.microbatch
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)
    cap = capture(args.arch, args.shape, multi_pod=args.multi_pod,
                  mesh_shape=mesh_shape, reduced=args.reduced,
                  run_overrides=run_overrides or None)
    gm = cap["gm"]
    if args.dump_graph:
        text = gm.code
        with open(args.dump_graph, "w") as f:
            f.write(text)
        print(f"wrote {len(text)} chars of graph code to {args.dump_graph}")

    mf = model_flops_for(cap["cell"].run.model, SHAPES[args.shape])
    # one simulate() call: the report carries the parsed program and the
    # engine result, so the deep-dive below reuses the single costing pass
    rep = simulate(aten.parse_graph(gm), hw=H100, n_chips=cap["n_chips"],
                   model_flops_global=mf,
                   title=f"{args.arch} {args.shape}")
    prog, eng = rep.program, rep.engine
    print(rep.pa)
    print(f"\nmemory_analysis: {aten.memory_analysis(gm)}")

    print(f"\n== top {args.top} ops by modeled time ==")
    print(f"{'op':<44s}{'opcode':<18s}{'count':>9s}{'GF':>8s}{'GB':>9s}"
          f"{'commGB':>9s}{'t_total_ms':>11s}")
    for t in eng.top_ops[:args.top]:
        o = t.op
        print(f"{o.name[:43]:<44s}{o.opcode:<18s}{o.count:>9.0f}"
              f"{o.flops * o.count / 1e9:>8.1f}"
              f"{o.bytes_accessed * o.count / 1e9:>9.2f}"
              f"{o.comm_bytes * o.count / 1e9:>9.2f}"
              f"{t.t_op * o.count * 1e3:>11.2f}")

    # trip-count audit: group op counts
    counts = collections.Counter(o.count for o in prog.ops)
    print("\n== op-count histogram (multiplier -> n_ops) ==")
    for c, n in sorted(counts.items()):
        print(f"  x{c:<10.0f} {n}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _args(argv)
    if args.child:
        return analyze(args)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    sys.stdout.flush()
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.analyze",
                           *argv, "--child"], env=env).returncode


if __name__ == "__main__":
    raise SystemExit(main())
