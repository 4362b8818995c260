"""K1 and K2's plain versions against the reference's Pallas kernels.

The same inputs, made from a numpy seed as the reference's kernel test
distributes them, go through ``repro.kernels.stream`` (Pallas, interpret
mode, under x64) and its ``ref`` oracles, and through the port's
``elementwise_plain`` / ``stream_triad_plain`` and its CPU dispatch.
Tolerances are the reference's own (tests/test_kernels.py): 1e-12 relative
and absolute for the 28 Table-1 expressions; rtol 1e-5, atol 1e-6 for f32
Triad (1e-12 in f64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import stream as jstream
from repro_torch.kernels import ops
from repro_torch.kernels import stream

NP_DTYPES = {"f8": np.float64, "f4": np.float32, "i4": np.int32}
SIZES = [(4096, 512), (3 * 4096, 4096)]        # (n, Pallas block)


def _inputs(name: str, n: int, seed: int):
    """x1, x2, y0 as numpy arrays, distributed as the reference's test."""
    fn, n_in, din, dout = stream.EXPRS[name]
    rng = np.random.default_rng(seed)
    if din == "i4":
        x1 = rng.integers(-1000, 1000, n).astype(np.int32)
    else:
        x1 = (np.abs(rng.standard_normal(n)) + 0.5).astype(NP_DTYPES[din])
    x2 = (np.abs(rng.standard_normal(n)) + 0.5).astype(
        NP_DTYPES["f8" if din == "i4" else din])
    return x1, x2, np.zeros(n, NP_DTYPES[dout])


def test_exprs_match_the_reference_table():
    assert list(stream.EXPRS) == list(jstream.EXPRS)
    for name, (fn, n_in, din, dout) in jstream.EXPRS.items():
        assert stream.EXPRS[name][1:] == (n_in, din, dout)
    assert (stream.C0, stream.LOG2_10) == (jstream.C0, jstream.LOG2_10)
    import dataclasses

    from repro.configs import a64fx_kernelsuite as jsuite
    from repro_torch.configs import a64fx_kernelsuite as tsuite
    assert [dataclasses.astuple(k) for k in tsuite.KERNELS] \
        == [dataclasses.astuple(k) for k in jsuite.KERNELS]
    for name in ("TRIAD_L2_BYTES", "TRIAD_MEM_BYTES", "TRIAD_THREADS",
                 "PAPER_MEAN_DIFF_PCT", "PAPER_STD_DIFF_PCT",
                 "PAPER_MEAN_ABS_DIFF_PCT", "PAPER_WITHIN_10PCT_FRACTION"):
        assert getattr(tsuite, name) == getattr(jsuite, name), name


@pytest.mark.parametrize("n,block", SIZES)
@pytest.mark.parametrize("name", list(jstream.EXPRS))
def test_elementwise_plain_matches_pallas_and_ref(name, n, block):
    x1, x2, y0 = _inputs(name, n, seed=n + len(name))
    with jax.enable_x64(True):
        args = [jnp.asarray(a) for a in (x1, x2, y0)]
        pallas = np.asarray(jstream.elementwise(name, *args, block=block,
                                                interpret=True))
        want = np.asarray(jref.elementwise_ref(name, *args))
    targs = [torch.from_numpy(a) for a in (x1, x2, y0)]
    plain = stream.elementwise_plain(name, *targs)
    assert plain.dtype == stream.DTYPES[stream.EXPRS[name][3]]
    got = plain.numpy()
    assert got.dtype == want.dtype == pallas.dtype
    for oracle in (pallas, want):
        np.testing.assert_allclose(got.astype(np.float64),
                                   oracle.astype(np.float64),
                                   rtol=1e-12, atol=1e-12)
    # the CPU dispatch takes the plain version and launches nothing
    before = stream.elementwise.launches
    for fn in (stream.elementwise, ops.elementwise):
        assert torch.equal(fn(name, *targs, block=block), plain)
    assert stream.elementwise.launches == before


@pytest.mark.parametrize("dtype,tol", [(np.float32, (1e-5, 1e-6)),
                                       (np.float64, (1e-12, 1e-12))])
@pytest.mark.parametrize("n,block", [(1 << 14, 4096), (3 * 4096, 4096)])
def test_stream_triad_plain_matches_pallas(n, block, dtype, tol):
    rng = np.random.default_rng(n)
    a, b = (rng.standard_normal(n).astype(dtype) for _ in range(2))
    with jax.enable_x64(True):
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        pallas = np.asarray(jstream.stream_triad(ja, jb, 3.0, block=block,
                                                 interpret=True))
        want = np.asarray(jref.stream_triad_ref(ja, jb, 3.0))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = stream.stream_triad_plain(ta, tb, 3.0)
    assert got.dtype == ta.dtype
    for oracle in (pallas, want):
        np.testing.assert_allclose(got.numpy(), oracle, rtol=tol[0],
                                   atol=tol[1])
    before = stream.stream_triad.launches
    assert torch.equal(ops.stream_triad(ta, tb, 3.0, block=block), got)
    assert torch.equal(ops.stream_triad(ta, tb, 3.0, block=block, max_ctas=2),
                       got)
    assert stream.stream_triad.launches == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fit_entries(dtype):
    """poly16 is 16 Horner steps of y*x + 1.25; fill stores zeros."""
    x = torch.from_numpy(np.random.default_rng(0).random(2048) * 0.1 + 0.5
                         ).to(dtype)
    y = x.clone()
    for _ in range(16):
        y = y * x + 1.25
    assert torch.equal(stream.elementwise("poly16", x), y)
    z = stream.elementwise("fill", x)
    assert z.dtype == dtype and not z.any()
    assert stream.reads("fill") == (False, False, False)
    assert stream.reads("fma") == (True, False, True)
    assert stream.reads("pwr") == (True, True, False)


def test_errors_match_the_reference():
    x = torch.ones(3000, dtype=torch.float64)
    with pytest.raises(AssertionError):       # n % block, as in the reference
        stream.elementwise("add", x, x, block=2048)
    with pytest.raises(AssertionError):
        stream.stream_triad(x, x, block=2048)
    with pytest.raises(KeyError):
        stream.elementwise("tan", x)
    meta = torch.ones(2048, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        stream.elementwise("add", meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        stream.stream_triad(meta, meta)
