"""``tools/ssd_kernel_cost_torch.py`` against ``benchmarks/
ssd_kernel_cost.py`` at a reduced shape (B 1, S 512, H 2, P 16, N 32,
chunk 128), and the K4/K5 bounds it shares with ``chip_smoke.py``.

The port's plain path (``ssd_chunked`` forward and ``autograd.grad``,
captured and parsed) counts the same work as the reference's parse of its
jnp path, within 5 % in FLOPs: eager PyTorch runs the forward's y_diag
product M.x, which XLA drops because ``jax.grad`` returns no loss (one
(Q, P, Q) product a (batch, chunk, head): 4.19 MFLOP here, the whole gap
in the products).
"""
import ast
import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(B=1, S=512, H=2, P=16, N=32, chunk=128)


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "ssd_kernel_cost_torch", ROOT / "tools" / "ssd_kernel_cost_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tool_at_a_reduced_shape(tool, tmp_path):
    out = tmp_path / "cost.json"
    assert tool.main(["--batch", "1", "--seq", "512", "--heads", "2",
                      "--head-dim", "16", "--state", "32", "--chunk", "128",
                      "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["shape"] == {**SHAPE, "layers": 48, "microbatches": 8}
    plain, ker = res["plain_chunked"], res["kernels"]
    for side in (plain, ker):
        assert side["bytes"] > 0 and side["flops"] > 0
        assert side["memory_term_s"] == pytest.approx(
            side["bytes"] * 48 * 8 / res["spec"]["hbm_read_bw"])
        assert side["compute_term_s"] == pytest.approx(
            side["flops"] * 48 * 8 / res["spec"]["peak_bf16"])
    # the kernel side: the two bounds plus the path's ops outside them
    assert ker["bytes"] == pytest.approx(
        ker["k4"]["bytes"] + ker["k5"]["bytes"]
        + ker["outside_kernels"]["bytes"])
    assert 0.5 < res["hbm_traffic_cut"] < 1.0
    # the forward's M.x product, which XLA drops, is the dots' surplus
    Q = SHAPE["chunk"]
    cells = SHAPE["B"] * (SHAPE["S"] // Q) * SHAPE["H"]
    assert plain["dot_flops"] == 27262976 + cells * 2 * Q * Q * SHAPE["P"]


def test_plain_flops_within_5pct_of_the_reference_parse(tool):
    import benchmarks.ssd_kernel_cost as ref
    saved = {k: getattr(ref, k) for k in ("B", "S", "H", "P", "N", "CHUNK")}
    try:
        ref.B, ref.S, ref.H = SHAPE["B"], SHAPE["S"], SHAPE["H"]
        ref.P, ref.N, ref.CHUNK = SHAPE["P"], SHAPE["N"], SHAPE["chunk"]
        want = ref.jnp_ssd_traffic()
    finally:
        for k, v in saved.items():
            setattr(ref, k, v)
    got = tool.plain_cost(*(SHAPE[k] for k in ("B", "S", "H", "P", "N",
                                               "chunk")))
    assert got["flops"] == pytest.approx(want["flops"], rel=0.05)


def test_chip_smoke_imports_the_same_bound_functions(tool):
    from repro_torch.kernels import bounds
    assert tool.ssd_chunk_fwd_bound is bounds.ssd_chunk_fwd_bound
    assert tool.ssd_chunk_bwd_bound is bounds.ssd_chunk_bwd_bound
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)
                and n.module == "repro_torch.kernels.bounds" for a in n.names}
    assert {"ssd_chunk_fwd_bound", "ssd_chunk_bwd_bound"} <= imported
    called = {n.func.id for n in ast.walk(tree) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Name)}
    assert {"ssd_chunk_fwd_bound", "ssd_chunk_bwd_bound"} <= called


def test_bounds_at_mamba2_training_shape():
    """At mamba2-1.3b's training shape (B 4, L 2048, H 64, P 64, N 128, Q
    256, bf16) both kernels are bound by their bytes: K4 0.0617 ms and K5
    0.2426 ms, as chip_smoke.py printed them before the bounds moved to
    ``kernels.bounds``."""
    from repro_torch.kernels.bounds import (ssd_chunk_bwd_bound,
                                            ssd_chunk_fwd_bound)
    k4 = ssd_chunk_fwd_bound(4, 2048, 64, 64, 128, 256)
    k5 = ssd_chunk_bwd_bound(4, 2048, 64, 64, 128, 256)
    assert (k4.bound_by, k5.bound_by) == ("bytes", "bytes")
    assert round(k4.bound_ms, 4) == 0.0617 and round(k5.bound_ms, 4) == 0.2426
    assert k4.bytes == (2 * 2 * 4 * 2048 * 64 * 64 + 2 * 4 * 2048 * 64
                        + 2 * 2 * 4 * 2048 * 128 + 4 * 64
                        + 4 * (4 * 8 * 64) * (128 * 64 + 1))
