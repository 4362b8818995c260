"""One dry-run cell of the port captured at full width on a fake
production mesh, parsed and simulated.  Host code: it needs no card.

    PYTHONPATH=src python3 tools/cell_capture_torch.py \
        --arch chatglm3-6b --shape decode_32k [--multi-pod] [--out PATH]

Starts torch's fake process group of 256 ranks (512 with ``--multi-pod``),
builds ``launch.cell.build_cell(arch, shape, make_production_mesh())`` on
it and captures the cell (``Cell.capture``: one rank's ATen graph over fake
tensors, nothing allocated, the collectives of DTensor's redistributions
in it), parses it (``core.aten.parse_graph``) and simulates it on the
port's ``H100`` spec with ``n_chips`` and ``model_flops_for``.  Prints,
and writes to ``--out`` as JSON, the mesh's, the capture's and the parse's
seconds on the host clock (and the whole run's from ``main``), the
process's peak resident memory, the graph's nodes, the program's ops, the
collectives by kind and group size (count and bytes a rank), the bytes by
opcode and the ten ops that move the most, and the simulated step time.
``--reduced`` takes the architecture's reduced widths and depth instead,
and ``--mesh DxM`` a (data, model) mesh of D x M fake ranks (for tests:
the reduced widths do not split over the production mesh's 16-way model
axis).  The mesh is a CPU one: a fake group runs nothing, and the
capture traces a Shard(a) -> Shard(b) redistribution as the all-to-all a
CUDA mesh issues (``launch.cell.capture_on_mesh``).  The capture itself is
``launch.dryrun.capture``, the dry-run's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.aten import parse_graph  # noqa: E402
from repro_torch.core.hwspec import H100  # noqa: E402
from repro_torch.core.simulate import simulate  # noqa: E402
from repro_torch.launch.cell import model_flops_for  # noqa: E402
from repro_torch.launch.dryrun import (PeakRSS, capture,  # noqa: E402
                                       collectives_by_kind)


TOP_OPS = 10


def capture_cell(arch: str, shape: str, multi_pod: bool = False,
                 reduced: bool = False, mesh_shape=None) -> dict:
    """The cell on a fake production mesh (or a (data, model) mesh of
    ``mesh_shape``), captured, parsed, simulated."""
    with PeakRSS() as rss:
        res = _capture_cell(arch, shape, multi_pod, reduced, mesh_shape)
    res["peak_rss_bytes"] = rss.peak
    return res


def _capture_cell(arch, shape, multi_pod, reduced, mesh_shape) -> dict:
    cap = capture(arch, shape, multi_pod=multi_pod, mesh_shape=mesh_shape,
                  reduced=reduced)
    cell, gm, chips = cap["cell"], cap["gm"], cap["n_chips"]
    t0 = time.perf_counter()
    prog = parse_graph(gm)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = simulate(prog, hw=H100, n_chips=chips,
                   model_flops_global=model_flops_for(cell.run.model,
                                                      cell.shape))
    simulate_s = time.perf_counter() - t0
    by_opcode = {}
    for o in prog.ops:
        by_opcode[o.opcode] = by_opcode.get(o.opcode, 0.0) \
            + o.bytes_accessed * o.count
    return {"cell": cell.name, "mesh": cap["mesh"],
            "n_chips": chips, "reduced": reduced,
            "mesh_s": cap["mesh_s"], "capture_s": cap["capture_s"],
            "parse_s": parse_s, "simulate_s": simulate_s,
            "graph_nodes": len(gm.graph.nodes), "ops": len(prog.ops),
            "flops": prog.flops, "bytes": prog.bytes_accessed,
            "comm_bytes": prog.comm_bytes,
            "collectives": collectives_by_kind(prog),
            "bytes_by_opcode": by_opcode,
            "top_ops": [{"name": o.name, "opcode": o.opcode, "dtype": o.dtype,
                         "bytes": o.bytes_accessed, "comm_bytes": o.comm_bytes}
                        for o in sorted(prog.ops, key=lambda o: (
                            -o.bytes_accessed, o.name))[:TOP_OPS]],
            "t_est_s": rep.t_est, "roofline": rep.roofline.as_dict(),
            "spec": H100.name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DxM: a (data, model) mesh instead of the "
                         "production one (for tests)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    mesh_shape = (tuple(int(x) for x in args.mesh.split("x")) if args.mesh
                  else None)
    res = capture_cell(args.arch, args.shape, args.multi_pod, args.reduced,
                       mesh_shape)
    res["wall_s"] = time.perf_counter() - t0
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps({"cell_capture": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
