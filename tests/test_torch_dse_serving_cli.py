"""The port's DSE and serving CLIs and the ``serve_lm`` example on the CPU.

``tools/dse_sweep_torch.py --quick --backend numpy --device cpu`` writes its
schema, with the fused-vs-loop race bit-identical (its 10x floor is held
on the card), and its estimates equal the reference's ``sweep_workload``
on the same synthetic DAG; ``tools/serving_sweep_torch.py --quick`` writes the
reference's quick payload, equal in everything but ``wall_s``; the full
mode's pricing runs for one model.  ``examples/serve_lm_torch.py`` trains a
few steps and serves on the CPU (the accuracy assert needs its 500 steps,
which run on the card), and raises without a card unless asked for the CPU.
"""
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"
sys.path.insert(0, str(TOOLS))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def example():
    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", ROOT / "examples" / "serve_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dse_quick_writes_its_schema_on_the_cpu(tmp_path):
    import dse_sweep_torch as cli
    import sched_throughput_torch
    from benchmarks import dse_sweep as ref_cli
    from benchmarks.sched_throughput import synthetic_program
    from repro.core import dse as ref_dse

    ours = sched_throughput_torch.synthetic_program(cli.QUICK_N_OPS)
    theirs = synthetic_program(ref_cli.QUICK_N_OPS)
    assert [dataclasses.asdict(o) for o in ours.ops] \
        == [dataclasses.asdict(o) for o in theirs.ops]
    # the 10x floor is a speed gate, enforced on the card (chip_smoke phase
    # 28); a CPU shared with other test workers is no place to time it
    assert cli.SPEEDUP_FLOOR == ref_cli.SPEEDUP_FLOOR == 10.0
    out = tmp_path / "dse_quick.json"
    assert cli.main(["--quick", "--backend", "numpy", "--device", "cpu",
                     "--floor", "1", "--out", str(out)]) == 0
    d = json.loads(out.read_text())
    assert {"schema", "mode", "n_specs", "n_ops", "throughput",
            "floor_speedup", "t_est_min_s", "t_est_max_s"} <= set(d)
    assert (d["mode"], d["n_specs"], d["n_ops"]) == ("quick", 64, 2000)
    thr = d["throughput"]
    assert thr["bit_identical"] and thr["speedup"] >= d["floor_speedup"] == 1
    assert (d["card"], d["device"], thr["backend"]) == ("cpu", "cpu", "numpy")
    want = ref_dse.sweep_workload(theirs, ref_dse.spec_grid(
        ref_dse.generate_grid()))["t_est"]
    assert (d["t_est_min_s"], d["t_est_max_s"]) \
        == (float(want.min()), float(want.max()))


def test_serving_quick_equals_the_references(tmp_path):
    import serving_sweep_torch as cli
    from benchmarks import serving_sweep as ref_cli
    assert [k.label for k in cli.POLICIES] \
        == [k.label for k in ref_cli.POLICIES]
    assert (cli.N_REQUESTS, cli.LOAD_FACTOR, cli.SEED, cli.FULL_MODELS) \
        == (ref_cli.N_REQUESTS, ref_cli.LOAD_FACTOR, ref_cli.SEED,
            ref_cli.FULL_MODELS)
    out = tmp_path / "serving_quick.json"
    assert cli.main(["--quick", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    want = json.loads(json.dumps(ref_cli.run_quick(60.0)))
    assert got.pop("wall_s") > 0 and want.pop("wall_s") > 0
    assert got == want
    assert sorted(got["models"]) == ["chat", "decode-heavy"]


def test_serving_full_mode_prices_one_model(tmp_path):
    """The full mode's path on chatglm3-6b at 60 requests: captures and
    cost cells cached in the given directories, every policy's row, and
    the comparison with the reference's committed fronts."""
    import serving_sweep_torch as cli
    out = cli.run_full(["chatglm3-6b"], 60, tmp_path / "programs",
                       tmp_path / "cost")
    row = out["models"]["chatglm3-6b"]
    assert sorted(row["policies"]) == sorted(k.label for k in cli.POLICIES)
    assert set(row["pareto"]) <= set(row["policies"])
    assert [b for b, _ in row["decode_grid_us"]] == [1, 4, 16, 64]
    assert len(list((tmp_path / "cost").glob("*.json"))) == 5
    ref = json.loads((ROOT / "BENCH_serving.json").read_text())
    vs = cli.against_reference(ref, out)["chatglm3-6b"]
    assert vs["bytes_per_token"] == vs["reference_bytes_per_token"] == 28672
    assert vs["reference_pareto"] == ref["models"]["chatglm3-6b"]["pareto"]


def test_the_dse_comparison_holds_the_reference_against_itself():
    import dse_sweep_torch as cli
    ref = json.loads((ROOT / "BENCH_dse.json").read_text())
    vs = cli.against_reference(ref, ref)
    assert set(vs) == set(ref["per_workload"]) and len(vs) == 10
    assert all(v["kendall_tau"] == 1.0 and v["best_spec_agrees"]
               for v in vs.values())


def test_the_dse_cli_raises_without_card(no_card, tmp_path):
    import dse_sweep_torch as cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--quick", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_the_serving_cli_says_it_needs_no_card(capsys):
    import serving_sweep_torch as cli
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    assert "needs no card" in " ".join(capsys.readouterr().out.split())


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mamba2-1.3b"])
def test_serve_lm_example_trains_and_serves_on_the_cpu(arch, capsys):
    r = example().serve_arch(arch, steps=3, device="cpu")
    assert r["arch"] == arch and r["total"] == 4 * 12
    assert 0 <= r["hits"] <= r["total"]
    out = capsys.readouterr().out
    assert "train step 2: loss" in out and "rule-following accuracy" in out


def test_serve_lm_example_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example().main(["--steps", "1"])


def test_serve_lm_example_loads_no_jax_and_no_repro():
    code = ("import runpy, sys; runpy.run_path("
            f"{str(ROOT / 'examples' / 'serve_lm_torch.py')!r}, "
            "run_name='example'); bad = sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'benchmarks')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert proc.returncode == 0, proc.stdout + proc.stderr
