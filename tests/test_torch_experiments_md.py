"""``tools/experiments_md_torch.py`` against ``benchmarks/experiments_md.py``.

* The five sections whose JSON keeps the reference's schema (the zoo,
  sampling, DSE, cluster and serving files) render the same text as the
  reference's functions on the same file: the reference module's path
  constants are pointed at the port's committed ``BENCH_*_torch.json``.
* Regenerating EXPERIMENTS_torch.md, without dry-run artifacts as in a
  fresh checkout, gives the committed bytes; it quotes no TPU figure, and
  ``tools/md_linkcheck.py`` passes on it.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks import experiments_md as ref

ROOT = Path(__file__).resolve().parents[1]
SECTIONS = {"zoo_section": ("ZOO_JSON", "BENCH_model_zoo_torch.json"),
            "sampling_section": ("SAMPLING_JSON",
                                 "BENCH_sampling_torch.json"),
            "dse_section": ("DSE_JSON", "BENCH_dse_torch.json"),
            "cluster_section": ("CLUSTER_JSON", "BENCH_cluster_torch.json"),
            "serving_section": ("SERVING_JSON", "BENCH_serving_torch.json")}


@pytest.fixture
def port(monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "experiments_md_torch", ROOT / "tools" / "experiments_md_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("KERNEL_JSON", "TRIAD_JSON", "ZOO_JSON", "SAMPLING_JSON",
                 "DSE_JSON", "CLUSTER_JSON", "SERVING_JSON"):
        monkeypatch.setattr(mod, name, ROOT / getattr(mod, name).name)
    monkeypatch.setattr(mod, "DRY", tmp_path / "no_dryrun")
    return mod


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_a_shared_schema_section_renders_as_the_reference(section, port,
                                                          monkeypatch):
    const, name = SECTIONS[section]
    monkeypatch.setattr(ref, const, ROOT / name)
    text = getattr(port, section)()
    assert text == getattr(ref, section)()
    assert not text.startswith("_run")            # the file is there


def test_regenerating_gives_the_committed_bytes(port):
    assert port.render() == (ROOT / "EXPERIMENTS_torch.md").read_text()


def test_no_tpu_figure_and_links_resolve(port):
    text = port.render()
    for word in ("TPU", "v5e", "tpu_v"):
        assert word not in text
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in text
    proc = subprocess.run([sys.executable, str(ROOT / "tools" /
                                               "md_linkcheck.py"),
                           str(ROOT / "EXPERIMENTS_torch.md")],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
