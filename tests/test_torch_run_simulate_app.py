"""``tools/run_torch.py`` and ``examples/simulate_app_torch.py`` on the CPU.

* ``run_torch.py --quick --device cpu`` (the plain K1 and K2 functions)
  writes its JSON into the given directory and ends with the reference's
  ``name,us_per_call,derived`` CSV, under the reference's row names (the
  Triad rows by CTA cap where the reference's count host threads).
* ``simulate_app_torch.py --reduced --mesh 2x2`` prints the PA report, the
  memory analysis in GiB and whether the cell fits the H100's 80 GB.
"""
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_run_torch_quick_on_the_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "run_torch", ROOT / "tools" / "run_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--quick", "--device", "cpu", "--out-dir",
                     str(tmp_path)]) == 0
    out = capsys.readouterr().out
    ks = json.loads((tmp_path / "kernel_suite.json").read_text())
    tr = json.loads((tmp_path / "triad.json").read_text())
    assert ks["device"] == tr["device"] == "cpu"
    csv = out.split("\nname,us_per_call,derived\n")[1].strip().splitlines()
    names = [line.split(",")[0] for line in csv]
    assert names[:len(ks["kernels"])] == [f"kernel.{k}" for k in ks["kernels"]]
    assert "kernel_suite.mean_abs_diff" in names
    assert "kernel_suite.within_10pct" in names
    for section in ("triad_l2", "triad_mem"):
        assert [n for n in names if n.startswith(section + ".")] == [
            f"{section}.t{r['ctas']}" for r in tr[section]]
    assert all(re.fullmatch(r"kernel\.\w+,[\d.]+,diff_pct=-?[\d.]+", row)
               for row in csv if row.startswith("kernel."))
    assert "no artifacts under" in out         # the roofline, absent
    assert not (ROOT / "experiments" / "bench_torch" / "triad.json").exists() \
        or (ROOT / "experiments" / "bench_torch").is_dir()


def test_simulate_app_at_reduced_width(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "simulate_app_torch.py"),
         "--arch", "chatglm3-6b", "--shape", "decode_32k", "--reduced",
         "--mesh", "2x2", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    r = json.loads((tmp_path / "single_pod" /
                    "chatglm3-6b__decode_32k.json").read_text())
    assert r["pa_report"] in out
    assert "memory_analysis per rank: {'argument_bytes': '" in out
    assert "fits the H100's 80 GB: True" in out
