"""The paper's evaluation kernels: Table 1's 28 expressions (K1) and STREAM
Triad (K2), over contiguous 1-D tensors.

Counterpart of ``repro.kernels.stream``.  ``EXPRS`` has the reference's
names, arities and dtypes, in torch.  Two versions of each function live
here:

* the CUDA kernels ``csrc/stream.cu`` (Hopper, built by ``_build``), launched
  for tensors on a CUDA device: K1 reads only the arrays its expression uses
  (x2 for the two-input expressions, y0 for ``fma``), where the Pallas kernel
  DMAs all three, four elements a thread in 16-byte vectors when every
  array is 16-byte aligned (the kernel picks its path and grid itself);
  K2 takes ``max_ctas``, a cap on the number of CTAs, for the Figs. 4/5
  sweep over SMs;
* ``elementwise_plain`` and ``stream_triad_plain``, the same functions in
  plain PyTorch, used for tensors on the CPU and as the kernels' yardstick on
  the card.

Besides the 28, K1 has two entries that the fit of the H100 spec needs
(``core.calibrate.fit_h100``), in f64 and f32: ``poly16``, a 16-deep Horner
chain (32 flops an element; the kernel runs it as FMAs, the plain version
as a product and a sum), and ``fill``, a pure store of zeros.

Dispatch is by the tensors' device and never falls back: a CUDA tensor
launches the kernel or raises.  ``elementwise.launches`` and
``stream_triad.launches`` count kernel launches.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import _build

C0 = 1.6180339887  # the paper's scalar constant (value irrelevant)
LOG2_10 = 3.321928094887362


def _exp10(x):
    return torch.exp2(x * LOG2_10)


# name -> (fn(x1, x2, y), n_inputs, in_dtype, out_dtype)
# Fortran semantics: aint=trunc, nint=round-to-int, anint=round-to-float,
# sign(a,b)=|a|*sgn(b), mod(a,b)=a-int(a/b)*b (Fortran MOD, not modulo).
# torch.round rounds half to even, as jnp.rint does.
EXPRS: dict[str, tuple[Callable, int, str, str]] = {
    "add":   (lambda a, b, y: a + b, 2, "f8", "f8"),
    "sub":   (lambda a, b, y: a - b, 2, "f8", "f8"),
    "mul":   (lambda a, b, y: a * b, 2, "f8", "f8"),
    "fma":   (lambda a, b, y: y + C0 * a, 1, "f8", "f8"),
    "div":   (lambda a, b, y: a / b, 2, "f8", "f8"),
    "rev":   (lambda a, b, y: 1.0 / a, 1, "f8", "f8"),
    "sqrt":  (lambda a, b, y: torch.sqrt(a), 1, "f8", "f8"),
    "f2d":   (lambda a, b, y: a.to(torch.float64), 1, "f4", "f8"),
    "i2d":   (lambda a, b, y: a.to(torch.float64), 1, "i4", "f8"),
    "d2f":   (lambda a, b, y: a.to(torch.float32), 1, "f8", "f4"),
    "d2i":   (lambda a, b, y: a.to(torch.int32), 1, "f8", "i4"),
    "aint":  (lambda a, b, y: torch.trunc(a), 1, "f8", "f8"),
    "nint":  (lambda a, b, y: torch.round(a).to(torch.int32), 1, "f8", "i4"),
    "anint": (lambda a, b, y: torch.round(a), 1, "f8", "f8"),
    "abs":   (lambda a, b, y: torch.abs(a), 1, "f8", "f8"),
    "max":   (lambda a, b, y: torch.maximum(a, b), 2, "f8", "f8"),
    "min":   (lambda a, b, y: torch.minimum(a, b), 2, "f8", "f8"),
    "mod":   (lambda a, b, y: a - torch.trunc(a / b) * b, 2, "f8", "f8"),
    "sign":  (lambda a, b, y: torch.copysign(torch.abs(a), b), 2, "f8", "f8"),
    "atan":  (lambda a, b, y: torch.atan(a), 1, "f8", "f8"),
    "atan2": (lambda a, b, y: torch.atan2(a, b), 2, "f8", "f8"),
    "cos":   (lambda a, b, y: torch.cos(a), 1, "f8", "f8"),
    "sin":   (lambda a, b, y: torch.sin(a), 1, "f8", "f8"),
    "exp":   (lambda a, b, y: torch.exp(a), 1, "f8", "f8"),
    "exp10": (lambda a, b, y: _exp10(a), 1, "f8", "f8"),
    "log":   (lambda a, b, y: torch.log(a), 1, "f8", "f8"),
    "log10": (lambda a, b, y: torch.log10(a), 1, "f8", "f8"),
    "pwr":   (lambda a, b, y: torch.exp(b * torch.log(a)), 2, "f8", "f8"),
}

DTYPES = {"f8": torch.float64, "f4": torch.float32, "i4": torch.int32,
          "bf16": torch.bfloat16}


def _poly16(x):
    """Horner chain, 16 steps of y*x + 1.25: 32 flops per element."""
    y = x
    for _ in range(16):
        y = y * x + 1.25
    return y


# The fit-only entries: name -> fn(x1); in and out in x1's dtype (f64, f32).
FIT_EXPRS: dict[str, Callable] = {
    "poly16": _poly16,
    "fill": torch.zeros_like,
}

# Expression ids of csrc/stream.cu: EXPRS' order, then FIT_EXPRS'.
_EXPR_IDS = {name: i for i, name in enumerate([*EXPRS, *FIT_EXPRS])}
_FIT_DTYPE_CODES = {torch.float64: 0, torch.float32: 1}
TRIAD_THREADS = 1024      # K2's CTA


def reads(name: str) -> tuple[bool, bool, bool]:
    """Which of (x1, x2, y0) the kernel of ``name`` reads."""
    if name in FIT_EXPRS:
        return name != "fill", False, False
    return True, EXPRS[name][1] == 2, name == "fma"


def _out_dtype(name: str, x1: torch.Tensor) -> torch.dtype:
    return x1.dtype if name in FIT_EXPRS else DTYPES[EXPRS[name][3]]


def elementwise_plain(name: str, x1: torch.Tensor,
                      x2: Optional[torch.Tensor] = None,
                      y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1, also ``ref.elementwise_ref``:
    ``fn(x1, x2, y0)`` cast to the expression's output dtype."""
    if name in FIT_EXPRS:
        return FIT_EXPRS[name](x1)
    fn, n_in, din, dout = EXPRS[name]
    if x2 is None:
        x2 = x1
    if y0 is None:
        y0 = torch.zeros(x1.shape, dtype=DTYPES[dout], device=x1.device)
    return fn(x1, x2, y0).to(DTYPES[dout])


def stream_triad_plain(a: torch.Tensor, b: torch.Tensor,
                       scalar: float = 3.0) -> torch.Tensor:
    """Plain PyTorch version of K2, also ``ref.stream_triad_ref``:
    ``a + scalar * b``."""
    return a + scalar * b


def _check_1d(what: str, t: torch.Tensor, n: int, dtype: torch.dtype,
              device: torch.device) -> None:
    if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous 1-D tensor of {n} "
                         f"elements; got shape {tuple(t.shape)}, strides "
                         f"{t.stride()}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: want {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, x1 on {device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        lib = _build.load("stream").lib
        raise RuntimeError(f"{what} kernel failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")


def elementwise(name: str, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
                y0: Optional[torch.Tensor] = None, *,
                block: int = 2048) -> torch.Tensor:
    """Run one Table-1 kernel (or a fit entry) over 1-D ``x1`` of length n.

    ``x2`` defaults to ``x1`` and ``y0`` to zeros, as in the reference;
    ``n % min(block, n) == 0`` is asserted as there, for parity of errors
    (the CUDA kernel strides over the whole array whatever ``block`` is).
    Contiguous views at any element offset are taken: a misaligned one runs
    the kernel's scalar path.
    """
    if name not in EXPRS and name not in FIT_EXPRS:
        raise KeyError(f"unknown expression {name!r}")
    n = x1.shape[0]
    block = min(block, n)
    assert n % block == 0, (n, block)
    device = x1.device
    if device.type == "cpu":
        return elementwise_plain(name, x1, x2, y0)
    if device.type != "cuda":
        raise ValueError(f"elementwise runs on cpu or cuda, not {device}")
    out_dtype = _out_dtype(name, x1)
    if name in FIT_EXPRS:
        if x1.dtype not in _FIT_DTYPE_CODES:
            raise TypeError(f"{name} takes float64 or float32, not {x1.dtype}")
        in_dtype, dcode = x1.dtype, _FIT_DTYPE_CODES[x1.dtype]
    else:
        in_dtype, dcode = DTYPES[EXPRS[name][2]], 0
    r1, r2, r3 = reads(name)
    _check_1d("x1", x1, n, in_dtype, device)
    if r2 and x2 is not None:
        _check_1d("x2", x2, n, in_dtype, device)
    if r3 and y0 is not None:
        _check_1d("y0", y0, n, out_dtype, device)
    if r3 and y0 is None:
        y0 = torch.zeros(n, dtype=out_dtype, device=device)
    x2 = x1 if x2 is None else x2
    y = torch.empty(n, dtype=out_dtype, device=device)
    lib = _build.load("stream").lib
    err = lib.repro_stream_elementwise(
        _EXPR_IDS[name], dcode, x1.data_ptr() if r1 else None,
        x2.data_ptr() if r2 else None, y0.data_ptr() if r3 else None,
        y.data_ptr(), n, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, f"elementwise {name}")
    elementwise.launches += 1
    return y


elementwise.launches = 0


def stream_triad(a: torch.Tensor, b: torch.Tensor, scalar: float = 3.0, *,
                 block: int = 8192, max_ctas: Optional[int] = None
                 ) -> torch.Tensor:
    """y = a + scalar * b (STREAM Triad) over 1-D ``a``, ``b`` of one dtype.

    On the card ``max_ctas=None`` launches one CTA of 1024 threads per tile
    of 4096 elements where the tiles fill two waves of the CTAs the card
    holds at once, and else as many CTAs as it holds, striding over the
    tiles (for 16-byte aligned arrays; otherwise one element a thread);
    ``max_ctas=k`` launches exactly k such CTAs, striding.  ``n % min(block, n) == 0`` is
    asserted as in the reference.
    """
    n = a.shape[0]
    block = min(block, n)
    assert n % block == 0
    device = a.device
    if device.type == "cpu":
        return stream_triad_plain(a, b, scalar)
    if device.type != "cuda":
        raise ValueError(f"stream_triad runs on cpu or cuda, not {device}")
    if a.dtype not in _FIT_DTYPE_CODES:
        raise TypeError(f"stream_triad takes float64 or float32, not {a.dtype}")
    _check_1d("a", a, n, a.dtype, device)
    _check_1d("b", b, n, a.dtype, device)
    if max_ctas is not None and max_ctas < 1:
        raise ValueError(f"max_ctas must be at least 1, not {max_ctas}")
    y = torch.empty_like(a)
    lib = _build.load("stream").lib
    err = lib.repro_stream_triad(
        _FIT_DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(), float(scalar),
        y.data_ptr(), n, max_ctas or 0,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "stream_triad")
    stream_triad.launches += 1
    return y


stream_triad.launches = 0
