"""Multi-pod dry-run of the port: capture EVERY (arch x shape) cell on the
single-pod (16, 16) mesh AND the 2-pod (2, 16, 16) mesh, estimate each
rank's memory from the capture (``core.aten.memory_analysis``), extract
the roofline terms (the capture's FLOPs and bytes, and the collectives'
bytes DTensor's redistributions issue), and feed the RIKEN-style
simulator on the ``H100`` spec.  Counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --force \\
        --jobs 4

Host code: nothing runs on a card.  A cell is ``launch.cell.build_cell`` on
``make_production_mesh(device_type="cpu")`` over torch's fake process
group of 256 or 512 ranks, captured by ``Cell.capture()`` (one rank's ATen
graph over fake tensors), parsed and simulated as
``tools/cell_capture_torch.py`` does.  The fake group's world size is
fixed once a process, so ``main`` runs each cell in a process of its own,
``--jobs`` at a time; a cell that raises, or that ``--timeout`` or
``--max-rss-gib`` stop, is reported with its exception (its output in
``<mesh>/<arch>__<shape>.log`` beside the artifacts).

Artifacts: ``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``, with
the keys the reference's readers take (``fmt_row``, the roofline table,
``EXPERIMENTS`` sections): ``t_lower_s`` holds the capture's seconds and
``t_compile_s`` the parse's and the simulation's; ``hbm_per_chip`` and
``fits_hbm`` are taken against ``H100.hbm_bytes``; ``memory_analysis`` is
``aten.memory_analysis`` of the capture (``Cell.donate_argnums`` marks the
donated inputs); ``xla_cost_analysis`` is None.  The port adds
``peak_rss_bytes`` (the process's peak resident memory over the
capture, parse and simulation), ``collectives`` (how often each kind
runs and its bytes a rank, by group size), ``grad_collectives`` (the
stacked parameters' gradient reductions in the layer loops' backward, by
count, and their bytes an instance), ``stacked_shards`` (each stacked
parameter's global shape and a rank's shard of it), ``live_at_peak``
(the five largest temporaries live at the memory peak: node, op,
shapes, dtypes, bytes), ``graph_nodes`` beside the Program's ``ops``, ``op_instances`` (the ops weighted by their counts)
and ``op_counts`` (ops by count).  The capture is loop-aware
(``core.aten``'s I-4: a microbatch or layer loop's body traced once and
counted its trips, as the reference's parse counts a ``lax.scan``);
``--unrolled`` unrolls every loop instead, to compare.  All seconds are host seconds and every
term is modelled: nothing here is a time on the card.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import warnings
from pathlib import Path
from typing import Optional

from ..configs import ARCHS, SHAPES, reduced_config, skipped_shapes_for
from ..core import aten
from ..core.hwspec import H100
from ..core.simulate import simulate
from ..models import params as pr
from .cell import all_cells, build_cell, model_flops_for
from .mesh import make_host_mesh, make_production_mesh, n_chips

HBM_PER_CHIP = H100.hbm_bytes
OUT_DIR = Path("experiments/dryrun_torch")
SRC = Path(__file__).resolve().parents[2]


# ------------------------------------------------------------ host metrics
def _rss_bytes() -> int:
    """This process's resident memory now (``/proc/self/statm``)."""
    pages = int(Path("/proc/self/statm").read_text().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE")


class PeakRSS:
    """The peak of this process's resident memory while in the context,
    sampled every 10 ms (``VmHWM`` is not in every kernel's
    ``/proc/self/status``, and ``getrusage``'s maximum carries a forking
    parent's over ``exec``)."""

    def __enter__(self):
        self.peak, self._stop = _rss_bytes(), threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, _rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())


def collectives_by_kind(prog) -> dict:
    """{"<opcode> x<group size>": {"count", "bytes"}}: how often a program
    runs a collective of each kind (an op in a loop as often as its count)
    and the bytes a rank sends in them."""
    out = {}
    for o in prog.ops:
        if o.opclass == "collective":
            c = out.setdefault(f"{o.opcode} x{o.group_size}",
                               {"count": 0, "bytes": 0.0})
            c["count"] += int(o.count)
            c["bytes"] += o.comm_bytes * o.count
    return out


# nodes a collective's operand passes through on its way from the op that
# made it: views, the pieces of a gather or scatter on a dim other than 0,
# and the waits of earlier collectives
_PASS = aten.VIEWS | {"cat", "clone", "wait_tensor", "_to_copy"}


def _source(node) -> str:
    """The op whose output a collective's operand carries: "<op>(shape)"
    of the first node back along the largest input that is not a view, a
    copy, a cast or another collective's wait."""
    import torch
    seen = 0
    while node.op == "call_function" and seen < 32:
        name = (aten._packet(node.target)
                if isinstance(node.target, torch._ops.OpOverload)
                else getattr(node.target, "__name__", str(node.target)))
        if name not in _PASS and name != "getitem" and not (
                aten._is_collective(node.target) and seen):
            val = node.meta.get("val")
            shape = tuple(val.shape) if isinstance(val, torch.Tensor) else ()
            return f"{name}{list(shape)}"
        ins = [a for a in node.all_input_nodes
               if isinstance(a.meta.get("val"), torch.Tensor)]
        if not ins:
            break
        node = max(ins, key=lambda a: a.meta["val"].numel())
        seen += 1
    return "input"


def collective_nodes(gm) -> list:
    """Each collective of a capture: {"node", "opcode", "group_size",
    "count" (its loops' trips), "bytes" (its operand's bytes an instance,
    as ``parse_graph`` charges it), "shape", "dtype", "grad_of" (the
    stacked parameter whose gradient ``aten.grad_in_placements`` reduces,
    else None), "source" (the op whose output it carries), "backward"}."""
    out = []
    for n in gm.graph.nodes:
        if n.op != "call_function" or not aten._is_collective(n.target) \
                or aten._packet(n.target) not in aten.COLLECTIVE_OPS:
            continue
        t = n.args[0].meta["val"]
        out.append({"node": n.name,
                    "opcode": aten.COLLECTIVE_OPS[aten._packet(n.target)],
                    "group_size": n.meta.get("group_size"),
                    "count": aten.trips(n),
                    "bytes": float(t.numel() * t.element_size()),
                    "shape": list(t.shape), "dtype": aten._dtype(t),
                    "grad_of": n.meta.get("grad_of"),
                    "source": _source(n.args[0]),
                    "backward": "loop_bwd" in n.meta})
    return out


def grad_collectives(nodes: list) -> dict:
    """The stacked parameters' gradient reductions (``collective_nodes``
    with ``grad_of``), by count: {"<count>": {"ops", "bytes"}}, "bytes"
    the sum of their operands' bytes an instance: at the layer loop's
    count, what a layer instance's gradient moves."""
    out = {}
    for c in nodes:
        if c["grad_of"] is not None:
            e = out.setdefault(f"{c['count']:g}", {"ops": 0, "bytes": 0.0})
            e["ops"] += 1
            e["bytes"] += c["bytes"]
    return out


# ------------------------------------------------------------ one cell
def capture(arch: str, shape_name: str, *, multi_pod: bool = False,
            mesh_shape=None, reduced: bool = False,
            layers: Optional[int] = None,
            run_overrides: Optional[dict] = None,
            act_rule_overrides: Optional[dict] = None,
            loops: bool = True) -> dict:
    """The cell captured on a fake production mesh (or a (data, model)
    mesh of ``mesh_shape``, for tests; ``reduced`` takes the
    architecture's reduced widths and depth, ``layers`` cuts the depth
    alone; ``loops=False`` unrolls the loops the capture otherwise counts):
    {"cell", "gm", "mesh", "n_chips", "mesh_s", "capture_s"}.  Starts
    torch's fake process group of the mesh's world and destroys it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = (mesh_shape[0] * mesh_shape[1] if mesh_shape
             else 512 if multi_pod else 256)
    t0 = time.perf_counter()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = (make_host_mesh(*mesh_shape, device_type="cpu") if mesh_shape
                else make_production_mesh(multi_pod=multi_pod,
                                          device_type="cpu"))
        mesh_s = time.perf_counter() - t0
        over = None
        if reduced:
            red = reduced_config(ARCHS[arch])
            over = {f.name: getattr(red, f.name)
                    for f in dataclasses.fields(red) if f.name != "name"}
        if layers is not None:
            over = dict(over or {}, n_layers=layers)
        cell = build_cell(arch, shape_name, mesh, model_overrides=over,
                          run_overrides=run_overrides,
                          act_rule_overrides=act_rule_overrides)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gm = cell.capture(loops=loops)
        capture_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    return {"cell": cell, "gm": gm,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "n_chips": n_chips(mesh), "mesh_s": mesh_s,
            "capture_s": capture_s}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: Path = OUT_DIR, force: bool = False,
             run_overrides: Optional[dict] = None,
             act_rule_overrides: Optional[dict] = None,
             tag: str = "", reduced: bool = False,
             mesh_shape=None, layers: Optional[int] = None,
             loops: bool = True) -> dict:
    """Capture, parse and simulate one cell and write its artifact (or read
    it, where it exists and not ``force``).  Needs a process without a
    process group (``main`` gives each cell one)."""
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    dest = Path(out_dir) / mesh_name / f"{arch}__{shape_name}{tag}.json"
    if dest.exists() and not force:
        return json.loads(dest.read_text())

    with PeakRSS() as rss:
        cap = capture(arch, shape_name, multi_pod=multi_pod,
                      mesh_shape=mesh_shape, reduced=reduced, layers=layers,
                      run_overrides=run_overrides,
                      act_rule_overrides=act_rule_overrides, loops=loops)
        cell, gm, chips = cap["cell"], cap["gm"], cap["n_chips"]
        t0 = time.perf_counter()
        prog = aten.parse_graph(gm)
        mf = model_flops_for(cell.run.model, SHAPES[shape_name])
        rep = simulate(prog, hw=H100, n_chips=chips, model_flops_global=mf,
                       title=f"{arch} {shape_name} {mesh_name}")
        t_compile = time.perf_counter() - t0
        mem = aten.memory_analysis(gm, top=5)
        live = [list(t) for t in mem.pop("live_at_peak")]
    cfg = cell.run.model
    peak = mem["peak_bytes_est"]
    result = {
        "arch": arch,
        "shape": shape_name,
        "kind": cell.kind,
        "mesh": mesh_name,
        "mesh_shape": cap["mesh"],
        "reduced": reduced,
        "n_layers": cfg.n_layers,
        "n_chips": chips,
        "t_lower_s": round(cap["capture_s"], 2),
        "t_compile_s": round(t_compile, 2),
        "fits_hbm": bool(peak and peak <= HBM_PER_CHIP) if peak else None,
        "hbm_per_chip": HBM_PER_CHIP,
        "model_flops_global": mf,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "microbatch": cell.run.microbatch,
        "roofline": rep.roofline.as_dict(),
        "engine": {
            "t_est": rep.engine.t_est,
            "t_roofline": rep.engine.t_roofline,
            "port_busy": rep.engine.port_busy,
            "bound_by": rep.engine.bound_by,
            "mxu_utilization": rep.engine.mxu_utilization,
            "collective_time_by_kind": rep.engine.collective_time_by_kind,
        },
        "program": rep.program_summary,
        "memory_analysis": mem,
        "live_at_peak": live,
        "xla_cost_analysis": None,
        "pa_report": rep.pa,
        "spec": H100.name,
        "graph_nodes": len(gm.graph.nodes),
        "loops": loops,
        "ops": len(prog.ops),
        "op_instances": sum(o.count for o in prog.ops),
        "op_counts": {f"{c:g}": n for c, n in sorted(collections.Counter(
            o.count for o in prog.ops).items())},
        "peak_rss_bytes": rss.peak,
        "collectives": collectives_by_kind(prog),
        "grad_collectives": grad_collectives(collective_nodes(gm)),
        "stacked_shards": {k: [list(full), list(local)] for k, (full, local)
                           in pr.stacked_shards(cell.model.param_specs(),
                                                cell.rules).items()},
    }
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(result, indent=1, sort_keys=True))
    return result


def fmt_row(r: dict) -> str:
    rf = r["roofline"]
    mem = r.get("memory_analysis") or {}
    peak_gib = (mem.get("peak_bytes_est") or 0) / 2**30
    return (f"{r['arch']:<24s}{r['shape']:<13s}{r['mesh']:<11s}"
            f"{rf['compute_s']:>10.4f}{rf['memory_s']:>10.4f}"
            f"{rf['collective_s']:>11.4f}  {rf['dominant']:<10s}"
            f"{rf['useful_flops_ratio']:>7.2f}{peak_gib:>9.2f}GiB"
            f"{r['t_compile_s']:>8.1f}s")


HEADER = (f"{'arch':<24s}{'shape':<13s}{'mesh':<11s}{'compute_s':>10s}"
          f"{'memory_s':>10s}{'collect_s':>11s}  {'dominant':<10s}"
          f"{'MF/HF':>7s}{'peak':>12s}{'parse+sim':>9s}")


# ------------------------------------------------------------ the CLI
def _child(argv) -> int:
    """One cell in this process (``main``'s worker): writes the artifact,
    or prints the exception's repr as its last line and returns 1."""
    arch, shape, mesh, out, over = argv
    over = json.loads(over)
    try:
        run_cell(arch, shape, multi_pod=mesh == "multi_pod",
                 out_dir=Path(out), force=True,
                 run_overrides=over.get("run"),
                 reduced=over.get("reduced", False),
                 mesh_shape=over.get("mesh_shape"),
                 layers=over.get("layers"), loops=over.get("loops", True))
    except Exception as e:  # noqa: BLE001 — the parent reports it
        traceback.print_exc()
        print(json.dumps({"error": repr(e)}), flush=True)
        return 1
    return 0


def _spawn(arch, shape, mesh_name, out_dir, over, timeout_s=None,
           max_rss=None) -> tuple:
    """(artifact or None, error or None, the child's output tail).  The
    child is killed past ``timeout_s`` seconds or ``max_rss`` bytes of
    resident memory, and the cell reported so."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    log = Path(out_dir) / mesh_name / f"{arch}__{shape}.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    t0, killed = time.perf_counter(), None
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--child",
             arch, shape, mesh_name, str(out_dir), json.dumps(over)],
            stdout=f, stderr=subprocess.STDOUT, env=env)
        while proc.poll() is None:
            time.sleep(0.5)
            wall = time.perf_counter() - t0
            rss = _rss_of(proc.pid)
            if timeout_s and wall > timeout_s:
                killed = f"killed: over {timeout_s:.0f} s"
            elif max_rss and rss > max_rss:
                killed = (f"killed: resident memory {rss / 2**30:.1f} GiB "
                          f"over {max_rss / 2**30:.0f} GiB after {wall:.0f} s")
            if killed:
                proc.kill()
                proc.wait()
    text = log.read_text()
    dest = Path(out_dir) / mesh_name / f"{arch}__{shape}.json"
    if proc.returncode == 0 and dest.exists():
        log.unlink()
        return json.loads(dest.read_text()), None, ""
    err = killed
    for line in reversed(text.strip().splitlines()):
        if err is None and line.startswith('{"error"'):
            err = json.loads(line)["error"]
            break
    return None, err or f"exit {proc.returncode}", text[-4000:]


def _rss_of(pid: int) -> int:
    try:
        pages = int(Path(f"/proc/{pid}/statm").read_text().split()[1])
    except (OSError, IndexError, ValueError):
        return 0
    return pages * os.sysconf("SC_PAGE_SIZE")


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "--child":
        return _child(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="one architecture id")
    ap.add_argument("--shape", default=None, help="one shape name")
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH/SHAPE", help="these cells only")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells captured at once, a process each")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced widths and depth (for tests)")
    ap.add_argument("--mesh-shape", default=None,
                    help="DxM: a (data, model) mesh instead of the "
                         "production one (for tests)")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds a cell may take before it is killed")
    ap.add_argument("--max-rss-gib", type=float, default=None,
                    help="resident GiB a cell may take before it is killed")
    ap.add_argument("--unrolled", action="store_true",
                    help="unroll every loop (the capture before loops were "
                         "counted), to compare")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    if args.cell:
        cells = [(a, s) for a, s in cells if f"{a}/{s}" in args.cell]
    if args.list:
        for a, s in cells:
            print(f"{a:<26s}{s}")
        for name, cfg in ARCHS.items():
            for shape, why in skipped_shapes_for(cfg):
                print(f"{name:<26s}{shape.name:<13s}SKIP: {why}")
        return 0

    over = {"reduced": args.reduced}
    if args.mesh_shape:
        over["mesh_shape"] = [int(x) for x in args.mesh_shape.split("x")]
    if args.microbatch is not None:
        over["run"] = {"microbatch": args.microbatch}
    if args.layers is not None:
        over["layers"] = args.layers
    if args.unrolled:
        over["loops"] = False
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)
    todo = [(arch, shape, "multi_pod" if multi else "single_pod")
            for multi in meshes for arch, shape in cells]
    print(HEADER, flush=True)
    failures = []
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        futures = []
        for arch, shape, mesh_name in todo:
            dest = out_dir / mesh_name / f"{arch}__{shape}.json"
            if dest.exists() and not args.force:
                futures.append(None)
            else:
                futures.append(pool.submit(
                    _spawn, arch, shape, mesh_name, out_dir, over,
                    args.timeout, args.max_rss_gib and args.max_rss_gib * 2**30))
        for (arch, shape, mesh_name), fut in zip(todo, futures):
            if fut is None:
                r, err = json.loads((out_dir / mesh_name
                                     / f"{arch}__{shape}.json").read_text()), None
            else:
                r, err, tail = fut.result()
            if err is None:
                print(fmt_row(r), flush=True)
                continue
            failures.append((arch, shape, mesh_name == "multi_pod", err))
            print(f"{arch:<24s}{shape:<13s}{mesh_name:<11s}FAILED: {err}",
                  flush=True)
            print(tail, file=sys.stderr, flush=True)
    # skipped cells, accounted
    for name, cfg in ARCHS.items():
        for shape, why in skipped_shapes_for(cfg):
            print(f"{name:<24s}{shape.name:<13s}{'(both)':<11s}"
                  f"SKIPPED: {why[:60]}...")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for f in failures:
            print("  ", f)
        return 1
    print("\nall cells captured")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
