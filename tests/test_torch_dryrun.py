"""``launch.dryrun`` against the reference's ``repro.launch.dryrun`` and its
readers.

* ``--list`` prints the reference's cells and skips (the reference's in a
  subprocess: its first lines set ``XLA_FLAGS`` to 512 host devices).
* ``run_cell`` at reduced width on a (2, 2) fake mesh, for chatglm3-6b's
  decode_32k and prefill_32k cells, writes artifacts that the reference's
  readers render to the same text as the port's copies: ``fmt_row`` (in a
  subprocess), ``benchmarks.roofline_table.fmt_markdown`` and
  ``benchmarks.experiments_md.dryrun_table``/``roofline_table`` (their
  path constants patched to the artifacts; the port's header names the
  card's HBM and the parse's and simulation's seconds where the
  reference's names its chip's and its compile's).
* The artifacts record the loop-aware capture's graph nodes, ops and
  their counts; ``--unrolled`` captures the same cells with every loop
  unrolled, to the same FLOPs, bytes and collective bytes, which
  ``tools/roofline_table_torch.py --against`` puts side by side.
* A cell that raises makes ``main`` exit 1 and list it.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CELLS = [("chatglm3-6b", "decode_32k"), ("chatglm3-6b", "prefill_32k")]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(SRC),
                               "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_list_equals_the_reference(capsys):
    want = _reference("import sys; from repro.launch.dryrun import main; "
                      "sys.argv = ['dryrun', '--list']; main()")
    assert dryrun.main(["--list"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 40          # 32 cells and 8 skips


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rows = [dryrun.run_cell(a, s, multi_pod=False, out_dir=out, force=True,
                            reduced=True, mesh_shape=(2, 2))
            for a, s in CELLS]
    return out, rows


def test_run_cell_writes_the_reference_keys(artifacts):
    out, rows = artifacts
    for (arch, shape), r in zip(CELLS, rows):
        path = out / "single_pod" / f"{arch}__{shape}.json"
        assert json.loads(path.read_text()) == r
        assert {"arch", "shape", "kind", "mesh", "n_chips", "t_lower_s",
                "t_compile_s", "fits_hbm", "hbm_per_chip",
                "model_flops_global", "param_count", "active_param_count",
                "microbatch", "roofline", "engine", "program",
                "memory_analysis", "xla_cost_analysis", "pa_report"} <= set(r)
        assert r["xla_cost_analysis"] is None and r["n_chips"] == 4
        assert r["hbm_per_chip"] == 80 * 10**9 and r["fits_hbm"] is True
        mem = r["memory_analysis"]
        assert mem["peak_bytes_est"] == (mem["argument_bytes"]
                                         + mem["output_bytes"]
                                         + mem["temp_bytes"]
                                         - mem["alias_bytes"])
        assert r["peak_rss_bytes"] > 0 and r["collectives"]
        # the loop-aware capture: the layer loop's ops count its trips,
        # prefill's 32 KV blocks a layer (of 1024 at 32k) the layers' times
        # theirs
        assert r["loops"] is True and r["ops"] < r["graph_nodes"]
        L = r["n_layers"]
        assert set(r["op_counts"]) == {"1", str(L)} | (
            {str(L * 32)} if shape == "prefill_32k" else set())
        assert r["op_instances"] == sum(float(c) * n for c, n in
                                        r["op_counts"].items()) \
            == sum(v["n"] for v in r["program"]["by_class"].values())
        assert sum(c["bytes"] for c in r["collectives"].values()) == \
            r["program"]["comm_bytes_per_device"]
        # a decode step donates its cache, which it returns updated
        assert (mem["alias_bytes"] > 0) == (r["kind"] == "decode")
    # an artifact is read back, not recomputed, without force
    again = dryrun.run_cell(*CELLS[0], multi_pod=False, out_dir=out,
                            reduced=True, mesh_shape=(2, 2))
    assert again == rows[0]


def test_fmt_row_renders_as_the_reference(artifacts):
    out, rows = artifacts
    code = ("import json, sys; from repro.launch.dryrun import fmt_row; "
            f"paths = sorted(__import__('pathlib').Path({str(out)!r})"
            ".glob('single_pod/*.json')); "
            "print(json.dumps([fmt_row(json.loads(p.read_text())) "
            "for p in paths]))")
    want = json.loads(_reference(code).splitlines()[-1])
    paths = sorted(out.glob("single_pod/*.json"))
    assert [dryrun.fmt_row(json.loads(p.read_text())) for p in paths] == want


def test_the_roofline_table_renders_as_the_reference(artifacts):
    from benchmarks import roofline_table as ref
    out, _ = artifacts
    port = _tool("roofline_table_torch")
    rows = port.load_rows("single_pod", out)
    assert len(rows) == len(CELLS)
    assert port.fmt_markdown(rows) == ref.fmt_markdown(rows)
    csv = port.fmt_csv(rows).splitlines()
    assert csv[0].startswith("arch,shape,kind,compute_s")
    assert len(csv) == 1 + len(CELLS)
    both = port.fmt_both(rows, []).splitlines()   # no (2, 16, 16) artifact
    assert len(both) == 2 + len(CELLS)
    assert all(line.endswith("| — | — | — |") for line in both[2:])


def test_the_experiments_tables_render_as_the_reference(artifacts,
                                                        monkeypatch):
    from benchmarks import experiments_md as ref
    out, _ = artifacts
    port = _tool("experiments_md_torch")
    monkeypatch.setattr(ref, "DRY", out)
    monkeypatch.setattr(port, "DRY", out)
    got, want = (port.dryrun_table("single_pod").splitlines(),
                 ref.dryrun_table("single_pod").splitlines())
    assert got[1:] == want[1:]                   # the separator and rows
    gh, wh = got[0].split("|"), want[0].split("|")
    assert [c for i, c in enumerate(gh) if i not in (9, 10)] == \
        [c for i, c in enumerate(wh) if i not in (9, 10)]
    assert (gh[9].strip(), gh[10].strip()) == ("fits 80 GB", "parse+sim s")
    assert port.roofline_table() == ref.roofline_table()


@pytest.fixture(scope="module")
def unrolled(tmp_path_factory):
    """The same cells captured with every loop unrolled (``--unrolled``)."""
    out = tmp_path_factory.mktemp("dryrun_unrolled")
    rc = dryrun.main(["--mesh", "single", "--reduced", "--mesh-shape", "2x2",
                      "--unrolled", "--out", str(out),
                      *(x for a, s in CELLS for x in ("--cell", f"{a}/{s}"))])
    assert rc == 0
    return out


def test_the_unrolled_sweep_holds_the_same_terms(artifacts, unrolled):
    """``--unrolled`` against the loop-aware capture: the same FLOPs, bytes
    and collective bytes a rank, more graph nodes and ops, each op once;
    ``tools/roofline_table_torch.py --against`` puts both sweeps' t_est
    and terms side by side, ``--capture`` lists each capture's counts."""
    out, rows = artifacts
    port = _tool("roofline_table_torch")
    old = port.load_rows("single_pod", unrolled)
    assert [(r["arch"], r["shape"]) for r in old] == sorted(CELLS)
    for r, o in zip(sorted(rows, key=lambda r: r["shape"]), old):
        assert o["loops"] is False and o["op_counts"] == {"1": o["ops"]}
        assert o["graph_nodes"] > r["graph_nodes"] and o["ops"] > r["ops"]
        assert o["op_instances"] == r["op_instances"]
        for key in ("flops_per_device", "bytes_per_device",
                    "comm_bytes_per_device"):
            assert o["program"][key] == r["program"][key], key
        assert o["roofline"]["compute_s"] == r["roofline"]["compute_s"]
        assert o["collectives"] == r["collectives"]
    compare = port.fmt_compare(port.load_rows("single_pod", out),
                               old).splitlines()
    assert len(compare) == 2 + len(CELLS)
    assert compare[2].startswith("| chatglm3-6b | decode_32k | single_pod "
                                 "| ")
    capture = port.fmt_capture(old).splitlines()
    assert len(capture) == 2 + len(CELLS) and "| graph nodes |" in capture[0]
    assert port.main(["--dir", str(out), "--against", str(unrolled)]) == 0
    both = port.fmt_both(port.load_rows("single_pod", out), [],
                         old).splitlines()
    assert len(both) == 2 + len(CELLS) and "t_est s old / new" in both[0]
    assert all(line.endswith("| — | — | — | — |") for line in both[2:])
    t_old, t_new = both[2].split(" | ")[5].split(" / ")
    assert t_old == t_new


def test_a_cell_that_raises_is_listed_and_fails_main(tmp_path, capsys):
    rc = dryrun.main(["--arch", "chatglm3-6b", "--shape", "train_4k",
                      "--mesh", "single", "--reduced", "--mesh-shape",
                      "2x2", "--microbatch", "3", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "1 FAILURES" in out and "all cells captured" not in out
    assert "('chatglm3-6b', 'train_4k', False, 'AssertionError()')" in out
    assert (tmp_path / "single_pod" / "chatglm3-6b__train_4k.log").exists()
