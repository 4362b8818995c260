"""The port stands alone: it imports no JAX and nothing of ``repro``, and
its entry points refuse to run on the CPU unless asked to."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad, *names)
sys.exit(1 if bad else 0)
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL],
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    # configs, models, kernels, serve, launch, from slice 3 data, train,
    # from slice 4 the simulator core and the kernel-suite config, and from
    # slice 9 the node engine and the scan kernel
    assert n_modules >= 60
    names = set(proc.stdout.split()[2:])
    assert {"repro_torch.launch.train", "repro_torch.data.synthetic",
            "repro_torch.train.trainer", "repro_torch.train.optimizer",
            "repro_torch.train.schedule", "repro_torch.train.checkpoint",
            "repro_torch.train.fault"} <= names
    assert {f"repro_torch.core.{m}" for m in (
        "hlo", "memory", "hwspec", "cost", "engine", "roofline", "stats",
        "compiled", "schedule", "pa", "simulate", "calibrate", "aten",
        "node", "sample", "cluster", "zoo", "dse", "serving")} <= names
    assert {"repro_torch.kernels.stream", "repro_torch.kernels.sched_scan",
            "repro_torch.configs.a64fx_kernelsuite"} <= names
    # slice 13: meshes
    assert {"repro_torch.parallel", "repro_torch.parallel.sharding",
            "repro_torch.parallel.collectives", "repro_torch.launch.mesh",
            "repro_torch.train.grad_compress"} <= names
    # slice 14: cells on the production meshes, the SSD kernels' bounds
    assert {"repro_torch.launch.cell", "repro_torch.kernels.bounds"} <= names
    # slice 15: the dry-run and its analysis
    assert {"repro_torch.launch.dryrun", "repro_torch.launch.analyze"} <= names


TOOLS = sorted((SRC.parent / "tools").glob("*_torch.py"))


@pytest.mark.parametrize("tool", TOOLS, ids=[t.stem for t in TOOLS])
def test_the_port_tools_load_no_jax_and_no_repro(tool):
    """Each port CLI (``tools/*_torch.py``) imports with only ``src`` and
    ``tools`` on the path, and loads neither JAX nor ``repro``."""
    code = (f"import runpy, sys; runpy.run_path({str(tool)!r}, "
            "run_name='tool'); bad = sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'benchmarks')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_port_tool_is_covered():
    assert {t.stem for t in TOOLS} >= {
        "sched_throughput_torch", "kernel_suite_torch", "triad_torch",
        "model_zoo_torch", "sampled_estimation_torch", "dse_sweep_torch",
        "serving_sweep_torch", "cluster_scaling_torch",
        "ssd_kernel_cost_torch", "cell_capture_torch",
        "roofline_table_torch", "run_torch", "experiments_md_torch"}
    assert {e.stem for e in EXAMPLES} >= {
        "quickstart_torch", "serve_lm_torch", "train_lm_torch",
        "simulate_app_torch"}


EXAMPLES = sorted((SRC.parent / "examples").glob("*_torch.py"))


@pytest.mark.parametrize("example", EXAMPLES, ids=[e.stem for e in EXAMPLES])
def test_the_port_examples_load_no_jax_and_no_repro(example):
    """Each port example (``examples/*_torch.py``) loads with only ``src``
    on the path, and loads neither JAX nor ``repro``."""
    code = (f"import runpy, sys; runpy.run_path({str(example)!r}, "
            "run_name='example'); bad = sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'benchmarks')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny(arch="chatglm3-6b"):
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models.lm import build_model
    model = build_model(reduced_config(ARCHS[arch]))
    return model, model.init(torch.Generator().manual_seed(0))


def test_serve_engine_raises_without_card(no_card):
    from repro_torch.serve.engine import ServeEngine
    model, params = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)
    ServeEngine(model, params, device="cpu")          # explicit CPU runs


def test_entry_points_raise_without_card(no_card):
    from repro_torch.launch import serve
    from repro_torch.models.convert import params_from_jax
    model, params = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1", "--max-new", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
    tree = {k: v for k, v in params.items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, model.cfg)


def test_ops_never_fall_back_to_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version."""
    from repro_torch.kernels import ops
    q = torch.zeros((1, 8, 4, 32), device="meta")
    k = torch.zeros((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.flash_attention(q, k, k, causal=True)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_ssm_entry_points_raise_without_card(no_card, arch):
    from repro_torch.launch import serve
    from repro_torch.models.ssm import init_mamba_cache
    from repro_torch.serve.engine import ServeEngine
    model, params = _tiny(arch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--reduced", "--requests", "1",
                    "--max-new", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mamba_cache(model.cfg, 1, torch.float32)
    ServeEngine(model, params, device="cpu").generate([[1, 2, 3]], 2)


def test_ssd_scan_on_cpu_never_touches_the_kernel_library(monkeypatch):
    """CPU tensors take the plain version: the CUDA library is never built or
    loaded, and no launch is counted."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ssd_scan as ssd

    def refuse(name):
        raise AssertionError(f"kernel library {name} loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", refuse)
    before = ssd.ssd_chunk.launches
    x = torch.randn(1, 40, 2, 8)
    dt = torch.rand(1, 40, 2)
    bc = torch.randn(1, 40, 1, 4).expand(1, 40, 2, 4)
    y, state = ops.ssd_scan(x, dt, -torch.ones(2), bc, bc, chunk=16)
    assert y.shape == x.shape and state.shape == (1, 2, 8, 4)
    assert ssd.ssd_chunk.launches == before


def test_ssd_scan_never_falls_back_to_the_cpu():
    from repro_torch.kernels import ops
    x = torch.zeros((1, 32, 2, 8), device="meta")
    bc = torch.zeros((1, 32, 2, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.ssd_scan(x, torch.zeros((1, 32, 2), device="meta"),
                     torch.zeros(2, device="meta"), bc, bc, chunk=16)


@pytest.mark.parametrize("name", ["flash_attention", "ssd_scan", "ssd_scan_bwd",
                                  "stream", "sched_scan"])
def test_ctypes_signatures_match_the_sources(name):
    """Each C entry point declared for ctypes exists in its CUDA source with
    as many parameters as argtypes: a mismatch would pass pointers as ints
    or shift every argument, which only the card would show."""
    import re

    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{name}.cu").read_text()
    for fn, (_, argtypes) in _build.SIGNATURES[name].items():
        m = re.search(rf'extern "C" [^(]*\b{fn}\(([^)]*)\)', src)
        assert m, f"{fn} not in {name}.cu"
        assert len(m.group(1).split(",")) == len(argtypes), fn


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "chatglm3-6b"])
def test_train_entry_points_raise_without_card(no_card, arch, tmp_path):
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch import train
    argv = ["--arch", arch, "--reduced", "--steps", "1", "--batch", "2",
            "--seq", "8"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    model, _ = _tiny(arch)
    run = RunConfig(model=model.cfg, shape=ShapeConfig("t", 8, 2, "train"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train_loop(model, run, n_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.build_training(model, run)
    assert train.main(argv + ["--device", "cpu", "--ckpt-dir",
                              str(tmp_path)]) == 0      # explicit CPU runs


def test_stream_on_cpu_never_touches_the_kernel_library(monkeypatch):
    """CPU tensors take K1's and K2's plain versions: the CUDA library is
    never built or loaded, and no launch is counted."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import stream

    def refuse(name):
        raise AssertionError(f"kernel library {name} loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", refuse)
    before = (stream.elementwise.launches, stream.stream_triad.launches)
    x = torch.rand(4096, dtype=torch.float64) + 0.5
    for name in stream.EXPRS:
        din = stream.DTYPES[stream.EXPRS[name][2]]
        ops.elementwise(name, x.to(din), x)
    ops.stream_triad(x, x, max_ctas=1)
    assert (stream.elementwise.launches,
            stream.stream_triad.launches) == before



@pytest.mark.parametrize("tool", ["kernel_suite_torch", "triad_torch",
                                  "model_zoo_torch",
                                  "sampled_estimation_torch"])
def test_the_calibration_and_zoo_clis_raise_without_card(no_card, tool,
                                                          tmp_path):
    import importlib
    sys.path.insert(0, str(SRC.parent / "tools"))
    mod = importlib.import_module(tool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--quick", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
