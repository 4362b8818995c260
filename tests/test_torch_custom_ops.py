"""The kernels as ``torch.library`` custom ops, on the CPU.

K3 (``repro_torch::flash_attention``), K4 (``repro_torch::ssd_chunk_fwd``)
and K5 (``repro_torch::ssd_chunk_bwd``): ``torch.library.opcheck`` on their
CPU implementations (the plain versions); their fake implementations give
the CPU outputs' shapes, dtypes and strides; the gradient of
``ops.ssd_scan`` through the ops is the one the plain versions give when
called directly, bit for bit, with B and C per head and broadcast over the
heads; and a captured kernel-path step holds one custom call per kernel
call.  Their CUDA implementations are held in
``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.core import aten
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.lm import build_model
from repro_torch.train.trainer import make_train_step

OPS = {"flash_attention": torch.ops.repro_torch.flash_attention.default,
       "ssd_chunk_fwd": torch.ops.repro_torch.ssd_chunk_fwd.default,
       "ssd_chunk_bwd": torch.ops.repro_torch.ssd_chunk_bwd.default}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


def _flash_args(seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q = _t(rng, 2, 4, 24, 32, dtype=dtype)
    k, v = _t(rng, 2, 2, 40, 32, dtype=dtype), _t(rng, 2, 2, 40, 32,
                                                   dtype=dtype)
    return q, k, v, True, 16, 16


def _ssd_args(seed=0, shared=False, dtype=torch.float32):
    """(x, dt, A, Bm, Cm) in the (B, nc, Q, H, .) layout; with ``shared``
    B and C are one group broadcast over the heads (stride 0)."""
    rng = np.random.default_rng(seed)
    Bsz, nc, Q, H, P, N = 2, 2, 16, 4, 8, 8
    x = _t(rng, Bsz, nc, Q, H, P, dtype=dtype)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (Bsz, nc, Q, H))
                          .astype(np.float32)).to(dtype)
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, H).astype(np.float32))
    if shared:
        Bm, Cm = (_t(rng, Bsz, nc, Q, 1, N, dtype=dtype)
                  .expand(Bsz, nc, Q, H, N) for _ in range(2))
    else:
        Bm, Cm = (_t(rng, Bsz, nc, Q, H, N, dtype=dtype) for _ in range(2))
    return x, dt, A, Bm, Cm


def _bwd_args(seed=0, shared=False, dtype=torch.float32):
    x, dt, A, Bm, Cm = _ssd_args(seed, shared, dtype)
    rng = np.random.default_rng(seed + 1)
    Bsz, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    return (x, dt, A, Bm, Cm, _t(rng, *x.shape, dtype=dtype),
            _t(rng, Bsz, nc, H, N, P), _t(rng, Bsz, nc, H))


def _cases():
    return [("flash_attention", _flash_args()),
            ("flash_attention", _flash_args(1, torch.bfloat16)),
            ("ssd_chunk_fwd", _ssd_args()),
            ("ssd_chunk_fwd", _ssd_args(1, shared=True)),
            ("ssd_chunk_fwd", _ssd_args(2, dtype=torch.bfloat16)),
            ("ssd_chunk_bwd", _bwd_args()),
            ("ssd_chunk_bwd", _bwd_args(1, shared=True))]


@pytest.mark.parametrize("case", range(len(_cases())))
def test_opcheck_on_the_cpu(case):
    name, args = _cases()[case]
    torch.library.opcheck(OPS[name], args)


@pytest.mark.parametrize("case", range(len(_cases())))
def test_fake_outputs_match_the_cpu_outputs(case):
    name, args = _cases()[case]
    real = OPS[name](*args)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = OPS[name](*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                           else a for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.stride(), f.device) \
            == (r.shape, r.dtype, r.stride(), r.device)


class _PlainChunk(torch.autograd.Function):
    """The intra-chunk pass on the plain versions called directly, with the
    casts of ``ssd_scan._SSDChunk``: the path before the custom ops."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return ssd.ssd_chunk_plain(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dstates, dgamma):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        dx, ddt, dB, dC, da = ssd.ssd_chunk_bwd_plain(
            x, dt, A, Bm, Cm, dy.to(x.dtype), dstates.float(), dgamma.float())
        return (dx, ddt.to(dt.dtype), da.sum((0, 1)).to(A.dtype),
                dB.to(Bm.dtype), dC.to(Cm.dtype))


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_ssd_scan_gradient_through_the_ops_is_the_plain_one(
        monkeypatch, shared, initial):
    rng = np.random.default_rng(3)
    Bsz, L, H, P, N = 2, 40, 4, 8, 8
    x = _t(rng, Bsz, L, H, P)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (Bsz, L, H))
                          .astype(np.float32))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, H).astype(np.float32))
    bc = [_t(rng, Bsz, L, 1 if shared else H, N) for _ in range(2)]
    init = _t(rng, Bsz, H, P, N) if initial else None
    dy, dfinal = _t(rng, Bsz, L, H, P), _t(rng, Bsz, H, P, N)

    def grads():
        leaves = [t.clone().requires_grad_(True)
                  for t in [x, dt, A, *bc] + ([init] if initial else [])]
        Bm, Cm = (t.expand(Bsz, L, H, N) for t in leaves[3:5])
        y, final = ops.ssd_scan(leaves[0], leaves[1], leaves[2], Bm, Cm,
                                chunk=16,
                                initial_state=leaves[5] if initial else None)
        return [y, final, *torch.autograd.grad(
            (y * dy).sum() + (final * dfinal).sum(), leaves)]

    got = grads()
    monkeypatch.setattr(ssd, "ssd_chunk", _PlainChunk.apply)
    want = grads()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = dict.fromkeys(OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for name, op in OPS.items():
            if func is op:
                self.calls[name] += 1
        return func(*args, **(kwargs or {}))


def _custom_calls(prog):
    got = dict.fromkeys(OPS, 0)
    for o in prog.ops:
        if o.opcode == "custom-call":
            name = next(k for k in OPS if o.name.startswith(k))
            got[name] += 1
    return got


@pytest.mark.parametrize("arch,what", [("mamba2-1.3b", "train"),
                                       ("zamba2-1.2b", "prefill"),
                                       ("chatglm3-6b", "prefill")])
def test_a_captured_kernel_path_step_has_one_custom_call_per_kernel_call(
        arch, what):
    cfg = reduced_config(ARCHS[arch])
    model = build_model(cfg, attn_impl="flash", ssd_impl="kernel")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    if what == "train":
        model.attn_impl = "blocked"      # K3 has no backward
        run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2, "train"),
                        param_dtype="float32", compute_dtype="float32")
        step, *_, opt_init = make_train_step(model, run)
        fn, args = step, (params, opt_init(params), batch)
        n_ssm = cfg.n_layers
        want = {"flash_attention": 0, "ssd_chunk_fwd": 2 * n_ssm,
                "ssd_chunk_bwd": n_ssm}       # remat: K4 again in backward
    else:
        def fn(p, b):
            with torch.no_grad():
                return model.prefill_fn(p, b)
        args = (params, batch)
        n_attn = {"dense": cfg.n_layers, "ssm": 0,
                  "hybrid": model.n_shared_invocations()}[cfg.family]
        want = {"flash_attention": n_attn,
                "ssd_chunk_fwd": 0 if cfg.family == "dense" else cfg.n_layers,
                "ssd_chunk_bwd": 0}
    with _CountOps() as counted:
        fn(*args)
    assert counted.calls == want
    before = (fa.flash_attention_bhsd.launches, ssd.ssd_chunk.launches,
              ssd.ssd_chunk_bwd.launches)
    prog = aten.parse_graph(aten.capture(fn, *args))
    assert _custom_calls(prog) == want
    assert (fa.flash_attention_bhsd.launches, ssd.ssd_chunk.launches,
            ssd.ssd_chunk_bwd.launches) == before


def test_a_custom_call_costs_its_operands_and_outputs_as_they_lie():
    """K4 as the simulator sees it: a data-class custom call, no FLOPs; a
    head-broadcast B or C is read once, its stride-0 view is not copied."""
    x, dt, A, Bm, Cm = _ssd_args(shared=True)
    (op,) = aten.parse_graph(aten.capture(
        lambda *a: torch.ops.repro_torch.ssd_chunk_fwd(*a),
        x, dt, A, Bm, Cm)).ops
    Bsz, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    assert (op.opcode, op.opclass, op.flops) == ("custom-call", "data", 0.0)
    assert op.read_bytes == 4 * (x.numel() + dt.numel() + H
                                 + 2 * Bsz * nc * Q * N)
    assert op.write_bytes == 4 * (x.numel() + Bsz * nc * H * N * P
                                  + Bsz * nc * H)
