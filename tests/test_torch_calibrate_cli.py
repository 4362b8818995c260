"""``calibrate.fit_cpu_host`` and the port's calibration and zoo CLIs.

``fit_cpu_host`` cannot be run from the reference here (it enters
``enable_x64``, which jax 0.9 removed), so its formulas are held by a
clock-free test: injected timings go through the fit, and every fitted
number is recomputed by hand from the reference's formulas (the store time
subtracted from the DRAM add, the LLC clamp, the per-opcode factors with
the stream time subtracted).  The CLIs run under ``--quick --device cpu``
and must write their JSON in the reference's schema.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.a64fx_kernelsuite import KERNELS_BY_NAME
from repro_torch.core import calibrate as cal
from repro_torch.core.hwspec import CPU_HOST
from repro_torch.kernels.stream import EXPRS

TOOLS = Path(__file__).resolve().parents[1] / "tools"
sys.path.insert(0, str(TOOLS))

# seconds by (name, n): dispatch 10 µs, poly16 on 32768 elements, adds in
# the LLC and in DRAM, a DRAM fill, and one time for each factor kernel
N_MEM, N_FAC, SCALE = 1 << 21, 1 << 15, 4
FACTOR_T = {"exp": 4e-3, "log": 5e-3, "sin": 6e-3, "cos": 6.5e-3,
            "atan": 9e-3, "sqrt": 1e-3, "div": 1.5e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_timer(times):
    calls = []

    def timer(name, n, repeats):
        calls.append((name, n, repeats))
        return times[(name, n)]
    return timer, calls


def injected(fill_s=2e-3):
    t = {("add", 8): 1e-5, ("poly16", N_FAC): 5e-4, ("add", N_FAC): 2e-5,
         ("add", N_MEM): 6e-3, ("fill", N_MEM): fill_s}
    for k, v in FACTOR_T.items():
        t[(k, KERNELS_BY_NAME[k].n * SCALE)] = v
    return t


@pytest.mark.parametrize("fill_s", [2e-3, 7e-3])
def test_fit_cpu_host_formulas_with_injected_timings(fill_s):
    """7e-3 s for the fill leaves no time for the loads: the read rate
    falls back to the blended add stream, as in the reference."""
    t = injected(fill_s)
    timer, calls = fake_timer(t)
    hw = cal.fit_cpu_host(N_MEM, N_FAC, size_scale=SCALE, timer=timer)
    su = 1e-5
    alu = 32.0 * N_FAC / (5e-4 - su)
    llc = 3 * 8 * N_FAC / (2e-5 - su)
    wr = 8 * N_MEM / (fill_s - su)
    loads = 6e-3 - su - 8 * N_MEM / wr
    rd = 2 * 8 * N_MEM / loads if loads > 0 else 3 * 8 * N_MEM / (6e-3 - su)
    assert (loads > 0) == (fill_s < 6e-3)
    assert hw.op_startup_ns == su * 1e9
    assert hw.vpu_flops == {"f64": alu, "f32": 2 * alu, "default": alu}
    assert hw.peak_flops == hw.vpu_flops
    assert hw.hbm_write_bw == wr and hw.hbm_read_bw == rd
    assert hw.vmem_bw == max(llc, rd, wr)
    assert hw.dma_overlap == 0.0 and hw.vmem_bytes == 24 * 2**20
    factors = {}
    for k, op in cal._FACTOR_FIT.items():
        n = KERNELS_BY_NAME[k].n * SCALE
        t_mem = EXPRS[k][1] * 8 * n / rd + 8 * n / wr
        factors[op] = max(1.0, (FACTOR_T[k] - su - t_mem) * alu / n)
        assert hw.opcode_factor[op] == factors[op], op
    assert hw.opcode_factor["remainder"] == factors["divide"]
    assert hw.transcendental_factor == max(2.0, factors["exponential"])
    for op, v in CPU_HOST.opcode_factor.items():        # the rest survive
        if op not in factors and op != "remainder":
            assert hw.opcode_factor[op] == v
    assert calls[0] == ("add", 8, 50)                   # the dispatch
    assert [c[0] for c in calls[1:5]] == ["poly16", "add", "add", "fill"]


def test_fit_cpu_host_times_the_plain_k1_functions():
    """Without a timer the fit measures the plain K1 functions on the CPU:
    positive, finite rates (the numbers themselves are this host's)."""
    hw = cal.fit_cpu_host(1 << 14, 1 << 12, size_scale=2)
    for v in (hw.vpu_flops["f64"], hw.hbm_read_bw, hw.hbm_write_bw,
              hw.vmem_bw, hw.op_startup_ns):
        assert 0 < v < float("inf")
    assert cal.measure_dispatch_overhead() > 0


def test_kernel_suite_cli_writes_the_schema(tmp_path):
    import kernel_suite_torch
    out = tmp_path / "ks.json"
    assert kernel_suite_torch.main(["--quick", "--device", "cpu",
                                    "--size-scale", "16",
                                    "--out", str(out)]) == 0
    d = json.loads(out.read_text())
    ref = json.loads((TOOLS.parent / "BENCH_kernel_suite.json").read_text())
    assert set(ref) <= set(d)
    assert set(d["summary"]) >= set(ref["summary"])
    assert set(d["scheduler_throughput"]) >= set(ref["scheduler_throughput"]) \
        - {"pr2_baseline_single_ops_per_s"}
    assert len(d["kernels"]) == 7 and d["device"] == "cpu"
    row = d["kernels"]["add"]
    assert set(row) >= set(ref["kernels"]["add"])
    assert set(row["a64fx_node_us"]) == {"1", "12", "48"}
    assert row["measured_us"] > 0 and row["a64fx_core_cycles_per_8elem"] > 0


def test_triad_cli_writes_the_schema(tmp_path):
    import triad_torch
    out = tmp_path / "triad.json"
    assert triad_torch.main(["--quick", "--device", "cpu",
                             "--out", str(out)]) == 0
    d = json.loads(out.read_text())
    assert set(d["calibration"]) == {"l2", "mem"}
    for name in ("triad_l2", "triad_mem"):
        assert [r["ctas"] for r in d[name]] == list(triad_torch.QUICK_CTAS)
        for r in d[name]:
            assert {"measured_s", "simulated_s", "measured_gbps",
                    "simulated_gbps", "diff_pct"} <= set(r)
            assert r["measured_s"] > 0


def test_model_zoo_cli_writes_the_schema_and_its_taus(tmp_path, monkeypatch):
    import model_zoo_torch
    monkeypatch.chdir(tmp_path)
    ref = TOOLS.parent / "BENCH_model_zoo.json"
    out = tmp_path / "zoo.json"
    assert model_zoo_torch.main(
        ["--arch", "chatglm3-6b", "--arch", "qwen1.5-32b", "--arch",
         "paligemma-3b", "--phases", "prefill,decode", "--device", "cpu",
         "--ref", str(ref), "--out", str(out)]) == 0
    d = json.loads(out.read_text())
    want = json.loads(ref.read_text())
    assert set(want) <= set(d) and d["device"] == "cpu"
    assert set(d["vs_reference"]) == {"prefill", "decode"}
    for ph, by_k in d["vs_reference"].items():
        assert set(by_k) == {"1", "12", "48"}
        assert all(-1.0 <= t <= 1.0 for t in by_k.values())
    assert (tmp_path / "experiments" / "zoo_programs").is_dir()
    # the tau against a ranking is +1 against itself, -1 reversed
    assert model_zoo_torch.taus_against(d, d)["decode"]["12"] == 1.0
    rev = {"rank": {ph: {k: v[::-1] for k, v in r.items()}
                    for ph, r in d["rank"].items()}}
    assert model_zoo_torch.taus_against(rev, d)["decode"]["12"] == -1.0


def test_sampled_estimation_cli_writes_the_schema(tmp_path, monkeypatch):
    """The accuracy floors hold (5 % error at <= 20 % of the instances);
    the wall-clock floors (speedup, budget) are off on a shared test CPU."""
    import sampled_estimation_torch as se
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(se, "DECODE_STEPS", 16)
    monkeypatch.setattr(se, "QUICK_MODELS", ("paligemma-3b",))
    out = tmp_path / "sampling.json"
    assert se.main(["--quick", "--device", "cpu",
                    "--speedup-floor", "0", "--budget", "0",
                    "--out", str(out)]) == 0
    d = json.loads(out.read_text())
    ref = json.loads((TOOLS.parent / "BENCH_sampling.json").read_text())
    assert set(ref) <= set(d)
    assert set(d["bench_dag"]) == set(ref["bench_dag"])
    rows = d["zoo"]["paligemma-3b"]
    assert set(rows) == {"train", "prefill", "decode"}
    assert rows["decode"]["trace_repeats"] == 16
    for row in rows.values():
        assert set(row) >= set(ref["zoo"]["chatglm3-6b"]["decode"])
        assert abs(row["reconstruction_error_pct"]) <= se.ERR_CEIL_PCT
        assert row["frac_ops_scheduled"] <= se.FRAC_CEIL
