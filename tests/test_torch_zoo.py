"""``repro_torch.core.zoo`` against ``repro.core.zoo``.

Bit for bit on one shared program: ``kendall_tau``, and
``estimate_program`` across the core-count axis with the zoo's 12-combo O3
grid (the reference's grid is rebuilt from its constants, ``zoo.py:75-78``:
its ``zoo_o3_knobs`` imports ``repro.core.calibrate``, which fails under
jax 0.9), on NumPy and on the port's scan through its plain version.  The
disk cache (a ``Program`` as JSON under a content-hash key) misses when
only the phase differs, and a two-model ``run_zoo`` round-trips its JSON.
The per-cell captures are in ``test_torch_zoo_cells.py``.
"""
import dataclasses
import json
import math
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.sched_throughput import synthetic_program
from repro.core import compiled as ref_compiled
from repro.core import hwspec as ref_hw
from repro.core import zoo as ref_zoo
from repro_torch.configs import ZOO_SHAPES
from repro_torch.core import hlo as pt_hlo
from repro_torch.core import hwspec as pt_hw
from repro_torch.core import sample as pt_sample
from repro_torch.core import zoo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_knobs():
    return ref_compiled.O3Knobs.from_grid(
        ref_hw.A64FX_CORE,
        [(w, mw, vw, qd) for w in ref_zoo.ZOO_O3_WINDOWS
         for mw in ref_zoo.ZOO_O3_MEM_WIDTHS
         for vw in ref_zoo.ZOO_O3_VPU_WIDTHS
         for qd in ref_zoo.ZOO_O3_QUEUE_DEPTHS])


def shared(n=400, seed=2):
    prog = synthetic_program(n, seed=seed)
    return prog, pt_hlo.Program(
        ops=[pt_hlo.OpStat(**dataclasses.asdict(o)) for o in prog.ops],
        entry=prog.entry, n_partitions=prog.n_partitions)


def test_kendall_tau_matches_the_reference():
    rng = random.Random(0)
    for n in (0, 1, 2, 5, 10):
        for _ in range(20):
            xs = [rng.choice([1.0, 2.0, 3.0, rng.random()]) for _ in range(n)]
            ys = [rng.choice([1.0, 2.0, rng.random()]) for _ in range(n)]
            assert zoo.kendall_tau(xs, ys) == ref_zoo.kendall_tau(xs, ys)
    assert zoo.kendall_tau([1, 2, 3], [3, 2, 1]) == -1.0


def test_the_o3_grid_is_the_references():
    got, want = zoo.zoo_o3_knobs(pt_hw.A64FX_CORE), ref_knobs()
    assert got.batch == want.batch == 12
    for name in ("window", "width", "depth"):
        assert np.array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("sampled", [False, True])
def test_estimate_program_matches_the_reference(backend, sampled):
    ref, port = shared()
    kw = dict(core_counts=(1, 12, 48), compute_dtype="f64",
              model_flops=1e9, arch="syn", phase="train")
    want = ref_zoo.estimate_program(
        ref, ref_hw.A64FX_CORE, o3_knobs=ref_knobs(),
        sampling=ref_zoo.SamplingConfig(interval_ops=64.0) if sampled
        else None, **kw)
    got = zoo.estimate_program(
        port, pt_hw.A64FX_CORE, o3_knobs=zoo.zoo_o3_knobs(pt_hw.A64FX_CORE),
        sampling=pt_sample.SamplingConfig(interval_ops=64.0) if sampled
        else None, backend=backend, device="cpu", **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for ce in got.per_core:
        assert math.isfinite(ce.t_est_s) and ce.t_est_s > 0
        assert 0 < ce.t_best_knobs_s and ce.best_knobs is not None


def test_helpers_match_the_reference():
    from repro.configs import ARCHS as JARCHS
    for arch in ("chatglm3-6b", "grok-1-314b", "whisper-large-v3"):
        for ph in ZOO_SHAPES:
            assert zoo.phase_model_flops(zoo.zoo_config(arch),
                                         ZOO_SHAPES[ph]) \
                == ref_zoo.phase_model_flops(ref_zoo.zoo_config(arch),
                                             ref_zoo.ZOO_SHAPES[ph])
            assert zoo.long_trace_repeats(arch, ph) \
                == ref_zoo.long_trace_repeats(arch, ph)
    assert zoo.zoo_workloads(["mamba2-1.3b"], ["decode", "train"]) \
        == ref_zoo.zoo_workloads(["mamba2-1.3b"], ["decode", "train"])
    for bad in ((["nope"], ["train"]), (["mamba2-1.3b"], ["nope"])):
        with pytest.raises(ValueError):
            zoo.zoo_workloads(*bad)
    assert set(JARCHS) == set(zoo.ARCHS)


def test_the_disk_cache_misses_when_only_the_phase_differs(tmp_path):
    """The zoo's prefill and decode shapes are equal, so the phase is in
    the key; a hit reads back the Program the capture parsed, exactly."""
    arch = "chatglm3-6b"
    assert ZOO_SHAPES["prefill"].seq_len == ZOO_SHAPES["decode"].seq_len
    keys = {ph: zoo.hlo_cache_key(arch, ph, ZOO_SHAPES["prefill"], "float32")
            for ph in ("prefill", "decode")}
    assert keys["prefill"] != keys["decode"]
    zoo.clear_trace_caches()
    progs = {ph: zoo.trace_phase(arch, ph, hlo_cache_dir=tmp_path)
             for ph in ("prefill", "decode")}
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 2 and all(
        zoo.hlo_cache_key(arch, ph, ZOO_SHAPES[ph], "float32") in f
        for ph, f in zip(("decode", "prefill"), files))
    assert len(progs["prefill"].ops) != len(progs["decode"].ops)
    zoo.clear_trace_caches()
    for ph, prog in progs.items():
        again = zoo.trace_phase(arch, ph, hlo_cache_dir=tmp_path)
        assert again is not prog and again.exact_dtypes
        assert [dataclasses.asdict(o) for o in again.ops] \
            == [dataclasses.asdict(o) for o in prog.ops]
    assert zoo.trace_phase(arch, "decode", hlo_cache_dir=tmp_path) \
        is zoo.trace_phase(arch, "decode")                  # in-process memo


def test_a_two_model_zoo_round_trips_its_json(tmp_path):
    seen = []
    report = zoo.run_zoo(models=["chatglm3-6b", "grok-1-314b"],
                         hlo_cache_dir=tmp_path,
                         progress=lambda a, p, pe, w: seen.append((a, p)))
    assert seen == [(a, p) for a in ("chatglm3-6b", "grok-1-314b")
                    for p in ("train", "prefill", "decode")]
    d = json.loads(report.to_json())
    assert d == json.loads(json.dumps(report.to_dict()))
    assert d["schema"] == 1 and d["core_counts"] == [1, 12, 48]
    ref_keys = json.loads((Path(__file__).resolve().parents[1]
                           / "BENCH_model_zoo.json").read_text())
    assert set(d) == set(ref_keys)
    cell = d["models"]["grok-1-314b"]["phases"]["decode"]
    want = ref_keys["models"]["grok-1-314b"]["phases"]["decode"]
    # the committed file predates the reference's sampling fields
    assert set(cell) == set(want) | {"sampling", "trace_repeats"}
    assert set(cell["per_core"]["12"]) == set(want["per_core"]["12"])
    for ph in d["phases"]:
        assert set(d["kendall_tau"][ph]) == set(ref_keys["kendall_tau"][ph])
        assert sorted(d["rank"][ph]["48"]) == ["chatglm3-6b", "grok-1-314b"]
    # a second run reads every cell from the disk cache: the same numbers
    zoo.clear_trace_caches()
    again = zoo.run_zoo(models=["chatglm3-6b", "grok-1-314b"],
                        hlo_cache_dir=tmp_path).to_dict()
    assert {k: v for k, v in again.items() if k != "wall_s"} \
        == {k: v for k, v in d.items() if k != "wall_s"}


def test_the_scan_backend_gives_the_same_zoo_cell():
    """One cell with the O3 grid on the port's scan (its plain version on
    the CPU) bit for bit with NumPy."""
    kw = dict(models=["qwen1.5-32b"], phases=["decode"])
    got = zoo.run_zoo(backend="torch", device="cpu", **kw).to_dict()
    want = zoo.run_zoo(**kw).to_dict()
    assert got["models"] == want["models"]


@pytest.mark.parametrize("name", ["cluster_workload", "mesh_rules_resolver",
                                  "run_cluster"])
def test_what_waits_for_a_later_item_raises(name):
    """These three raised until ``parallel/`` was ported; now each runs on
    chatglm3-6b and agrees with the reference (their full parity:
    ``test_torch_cluster_drivers.py``)."""
    if name == "cluster_workload":
        a, b = ref_zoo.cluster_workload("chatglm3-6b"), \
            zoo.cluster_workload("chatglm3-6b")
        for k in ("frac_attn", "layers", "d_model", "param_bytes",
                  "repeats", "seq_len", "batch", "moe_top_k"):
            assert getattr(b, k) == getattr(a, k), k
    elif name == "mesh_rules_resolver":
        ref, port = (z.mesh_rules_resolver("chatglm3-6b")
                     for z in (ref_zoo, zoo))
        for tp in range(1, 17):
            assert dataclasses.asdict(port(tp)) == \
                dataclasses.asdict(ref(tp)), tp
    else:
        kw = dict(models=["chatglm3-6b"], node_counts=(2, 4))
        got, want = (z.run_cluster(**kw).to_dict() for z in (zoo, ref_zoo))
        assert got["rank"] == want["rank"]
        assert {n: set(p) for n, p in
                got["models"]["chatglm3-6b"]["plans"].items()} == \
            {n: set(p) for n, p in
             want["models"]["chatglm3-6b"]["plans"].items()}
