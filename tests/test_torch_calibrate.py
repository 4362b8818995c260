"""The port's calibration loop on the CPU: the accuracy table, the O3 sweep,
the Triad fit and the H100 fit run end to end at tiny sizes, and agree with
the reference where the reference can run (its ``calibrate`` module cannot
be imported under jax 0.9, so ``_knob_spec`` is taken from its source)."""
import ast
import dataclasses
import math
from pathlib import Path

import pytest
import torch

import benchmarks.triad as ref_triad
from repro.core import hwspec as ref_hw
from repro_torch.configs.a64fx_kernelsuite import KERNELS
from repro_torch.core import calibrate as cal
from repro_torch.core.hwspec import CPU_HOST, H100

REF_CALIBRATE = (Path(__file__).resolve().parents[1] / "src" / "repro"
                 / "core" / "calibrate.py")


def _reference_knob_spec():
    tree = ast.parse(REF_CALIBRATE.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_knob_spec")
    ns = {"HardwareSpec": ref_hw.HardwareSpec}
    exec(compile(ast.Module([fn], []), str(REF_CALIBRATE), "exec"), ns)
    return ns["_knob_spec"]


@pytest.fixture(scope="module")
def table():
    torch.set_num_threads(1)
    return cal.kernel_accuracy_table(hw=CPU_HOST, size_scale=1,
                                     kernels=KERNELS[:3], keep_programs=True,
                                     device="cpu")


def test_accuracy_table_runs_on_the_cpu(table):
    assert [r.name for r in table.rows] == ["add", "sub", "mul"]
    for r in table.rows:
        assert r.n == KERNELS_N[r.name]
        for v in (r.measured_us, r.simulated_us, r.simulated_sched_us):
            assert math.isfinite(v) and v > 0
        assert math.isfinite(r.diff_pct) and r.bound_by
    assert len(table.programs) == 3
    assert table.programs[0].bytes_accessed == 24 * table.rows[0].n
    assert "paper: +1.3%, 7.8%, 6.6%, 82%" in table.report()


KERNELS_N = {k.name: k.n for k in KERNELS}


def test_sweep_o3_ranks_and_tunes_like_the_reference(table):
    sweep = cal.sweep_o3(table, CPU_HOST)
    n_combos = (len(cal.O3_WINDOWS) * len(cal.O3_MEM_WIDTHS)
                * len(cal.O3_VPU_WIDTHS) * len(cal.O3_QUEUE_DEPTHS))
    assert len(sweep.results) == n_combos
    means = [r["mean_abs_diff_pct"] for r in sweep.results]
    assert means == sorted(means)
    best = sweep.results[0]
    want = _reference_knob_spec()(
        ref_hw.CPU_HOST, best["inflight_window"], best["mem_issue_width"],
        best["vpu_issue_width"], best["queue_depth"])
    assert dataclasses.asdict(sweep.best) == dataclasses.asdict(want)
    assert "window" in sweep.report(3)


def test_sweep_o3_refuses_what_is_not_ported(table):
    """The reference's jax backend is not the port's (its scan on the card
    is ``backend="torch"``); core counts above 1 run the ported node
    engine (held against the reference in test_torch_node_batch.py)."""
    with pytest.raises(ValueError, match="torch"):
        cal.sweep_o3(table, CPU_HOST, backend="jax")
    with pytest.raises(ValueError, match="keep_programs"):
        cal.sweep_o3(cal.AccuracyTable(table.rows), CPU_HOST)
    sweep = cal.sweep_o3(table, CPU_HOST, core_counts=(1, 12))
    assert {r["n_cores"] for r in sweep.results} == {1, 12}
    assert sweep.best == cal.sweep_o3(table, CPU_HOST).best


@pytest.mark.parametrize("times", [
    {1: 4e-3, 2: 2.1e-3, 4: 1.2e-3, 8: 9e-4},
    {1: 1e-2, 2: 6e-3, 4: 6.5e-3, 8: 5.9e-3, 12: 6e-3}])
def test_triad_fit_is_the_reference_formula(monkeypatch, times):
    """benchmarks/triad.py's sweep on the same made-up times (its child
    processes replaced) gives the same fit and rows."""
    n = 786_432
    monkeypatch.setattr(ref_triad, "run_child",
                        lambda n_threads, n_elems, repeats: times[n_threads])
    want_rows, want_fit = ref_triad.sweep("made-up", n, list(times), 1)
    rows, fit = cal.triad_fit(3 * 8 * n, dict(times))
    assert fit == want_fit
    for r, w in zip(rows, want_rows, strict=True):
        assert r["ctas"] == w["threads"]
        for key in ("measured_s", "simulated_s", "measured_gbps",
                    "simulated_gbps", "diff_pct"):
            assert r[key] == w[key], key


def test_triad_scaling_runs_on_the_cpu():
    torch.set_num_threads(1)
    rows, fit = cal.triad_scaling(1 << 13, (1, 2, 4), repeats=3,
                                  device="cpu")
    assert [r["ctas"] for r in rows] == [1, 2, 4]
    assert fit["plateau"] >= fit["bw1"] > 0
    # The first count anchors the fit, so its simulated time is
    # nbytes / (nbytes / t): that float round trip gives back t exactly
    # for only ~92 % of times (the reference computes it the same way), so
    # its diff is 0 up to a few ulps, never exactly by construction.
    assert abs(rows[0]["diff_pct"]) <= 1e-9


def test_triad_fit_matches_the_reference_formula_bit_for_bit():
    """triad_fit on fixed times, no clock: every row and the fit equal
    benchmarks/triad.py's formula (its ``sweep`` body) on the same dict."""
    meas = {1: 1e-3, 2: 5.1e-4, 4: 2.9e-4, 8: 2.8e-4}
    nbytes = 3 * 8 * 786_432
    agg = {n: nbytes / t for n, t in meas.items()}
    bw1, plateau = agg[1], max(agg.values())
    rows, fit = cal.triad_fit(nbytes, dict(meas))
    assert fit == {"bw1": bw1, "plateau": plateau}
    assert [r["ctas"] for r in rows] == list(meas)
    for r in rows:
        n, t_meas = r["ctas"], meas[r["ctas"]]
        t_sim = nbytes / min(n * bw1, plateau)
        assert r["measured_s"] == t_meas
        assert r["simulated_s"] == t_sim
        assert r["measured_gbps"] == agg[n] / 1e9
        assert r["simulated_gbps"] == nbytes / t_sim / 1e9
        assert r["diff_pct"] == 100.0 * (t_sim - t_meas) / t_meas


def test_fit_h100_on_the_cpu_returns_an_h100_spec(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(cal, "N_L2", 1 << 12)
    monkeypatch.setattr(cal, "N_HBM", 1 << 13)
    hw = cal.fit_h100("cpu")
    assert hw.name == "h100" and hw.dma_overlap == 0.0
    assert hw.peak_flops == H100.peak_flops          # the data sheet's
    assert set(cal._FACTOR_FIT.values()) | {"remainder"} <= set(
        hw.opcode_factor)
    assert hw.opcode_factor["convert"] == H100.opcode_factor["convert"]
    assert hw.vmem_bw >= max(hw.hbm_read_bw, hw.hbm_write_bw)
    for v in (hw.op_startup_ns, hw.vpu_flops["f64"], hw.vpu_flops["f32"],
              hw.hbm_read_bw, hw.hbm_write_bw):
        assert math.isfinite(v) and v > 0


def test_entry_points_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (cal.fit_h100, cal.measure_launch_overhead,
                 lambda: cal.kernel_accuracy_table(hw=CPU_HOST),
                 lambda: cal.triad_scaling(1 << 13, (1,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
