"""``launch.analyze`` (the counterpart of ``repro.launch.analyze``) on the
reduced chatglm3-6b decode cell on a (2, 2) fake mesh, in a process of its
own: the PA report, the memory analysis, the top ops in the reference's
columns (each row ``eng.top_ops`` of the same capture, simulated here),
and the op-count histogram, whose counts sum to the program's ops and
hold the layer loop's trips."""
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

from repro_torch.configs import SHAPES
from repro_torch.core import aten
from repro_torch.core.hwspec import H100
from repro_torch.core.simulate import simulate
from repro_torch.launch.cell import model_flops_for
from repro_torch.launch.dryrun import capture

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "chatglm3-6b", "--shape", "decode_32k", "--reduced",
        "--mesh-shape", "2x2", "--top", "12"]


@pytest.fixture(scope="module")
def printed(tmp_path_factory):
    graph = tmp_path_factory.mktemp("analyze") / "graph.py"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analyze", *ARGS,
         "--dump-graph", str(graph)], capture_output=True, text=True,
        timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, graph


@pytest.fixture(scope="module")
def engine():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cap = capture("chatglm3-6b", "decode_32k", mesh_shape=(2, 2),
                      reduced=True)
    rep = simulate(aten.parse_graph(cap["gm"]), hw=H100,
                   n_chips=cap["n_chips"],
                   model_flops_global=model_flops_for(
                       cap["cell"].run.model, SHAPES["decode_32k"]),
                   title="chatglm3-6b decode_32k")
    return rep, aten.memory_analysis(cap["gm"]), cap["gm"]


def test_the_pa_report_and_memory_analysis(printed, engine):
    out, graph = printed
    rep, mem, gm = engine
    assert rep.pa in out
    assert f"memory_analysis: {mem}" in out
    assert graph.read_text() == gm.code
    assert f"wrote {len(gm.code)} chars of graph code" in out


def test_the_top_ops_are_the_engines(printed, engine):
    out, _ = printed
    rep, *_ = engine
    block = out.split("== top 12 ops by modeled time ==\n")[1]
    lines = block.splitlines()
    assert lines[0].split() == ["op", "opcode", "count", "GF", "GB",
                                "commGB", "t_total_ms"]
    want = []
    for t in rep.engine.top_ops[:12]:
        o = t.op
        want.append(f"{o.name[:43]:<44s}{o.opcode:<18s}{o.count:>9.0f}"
                    f"{o.flops * o.count / 1e9:>8.1f}"
                    f"{o.bytes_accessed * o.count / 1e9:>9.2f}"
                    f"{o.comm_bytes * o.count / 1e9:>9.2f}"
                    f"{t.t_op * o.count * 1e3:>11.2f}")
    assert lines[1:13] == want


def test_the_histogram_counts_every_op(printed, engine):
    out, _ = printed
    rep, *_ = engine
    hist = out.split("== op-count histogram (multiplier -> n_ops) ==\n")[1]
    rows = [re.match(r"\s*x(\S+)\s+(\d+)$", line) for line in
            hist.strip().splitlines()]
    assert all(rows)
    assert sum(int(m.group(2)) for m in rows) == len(rep.program.ops)
    # the capture is loop-aware: the layer loop's ops count its 2 trips
    # (the reduced model's layers), the embedding's and the head's once
    assert [m.group(1) for m in rows] == ["1", "2"]
