"""The loops inside a layer through ``core.aten.repeat``: the blocked
attention's KV blocks (``models.attention.blocked_attention``) and the SSD
inter-chunk recurrence (``models.ssm._recurrence``, the plain path, and
``kernels.ops.ssd_scan``, the kernel path), the reference's ``lax.scan``s
(``repro.models.attention``, ``repro.models.ssm``).

* Eager, each is its previous Python loop bit for bit (the loops as they
  stood are copied here): values and the gradients of every input, causal
  and full attention, a ragged last KV block and a ragged last chunk, f32
  and bf16.
* Reduced captures with 4 KV blocks and 4 chunks a layer (the helper
  ``tests/_loops.py`` at a KV block of 8 and a chunk of 8, 32 tokens; the
  (2, 2) fake-mesh cells at a KV block of 1024 and an SSM chunk of 1024,
  4096 tokens): the loop-aware Program equals the unrolled one in FLOPs
  by class, op instances, bytes and collective bytes by kind, with fewer
  graph nodes, and the blocks' and chunks' body counts their trips times
  the layers' and microbatches'.
* On the mesh the layer body counts n_micro x n_layers: each layer's
  backward hands the carry's gradient on in the layout the loop's exit
  gives it (mamba2-1.3b: the final norm's (Shard(0), Replicate())).
"""
import math
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from _loops import (assert_equal_programs, assert_loop_aware_cell_equals_unrolled,
                    cell_at_depth, fake, step)

from repro_torch.core import aten
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models import ssm
from repro_torch.models.attention import NEG_INF, blocked_attention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- the previous Python loops
def _previous_blocked(q, k, v, *, causal, block):
    """``blocked_attention``'s core as it stood: a Python loop over slices
    of the padded K and V (plain tensors)."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, Sq, KVH, G, D).float()
    block = min(block, max(Sk, 1))
    qpos = torch.arange(Sq)
    m = torch.full((B, KVH, G, Sq), NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, G, Sq, D), dtype=torch.float32)
    pad = (0, 0, 0, 0, 0, (-Sk) % block)
    kp, vp = F.pad(k, pad), F.pad(v, pad)
    for k0 in range(0, Sk, block):
        kb, vb = kp[:, k0:k0 + block], vp[:, k0:k0 + block]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.float())
        kpos = torch.arange(k0, k0 + block)
        invalid = kpos >= Sk
        if causal:
            invalid = invalid[None, :] | (qpos[:, None] < kpos[None, :])
        s = s.masked_fill(invalid, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(),
                          vb.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _previous_recurrence(gamma, S_c, carry):
    prev = []
    for c in range(S_c.shape[1]):
        prev.append(carry)
        carry = carry * gamma[:, c, :, None, None] + S_c[:, c]
    return torch.stack(prev, dim=1), carry


def _previous_ssd_scan(x, dt, A, Bm, Cm, chunk, initial_state=None):
    """``kernels.ops.ssd_scan`` as it stood (its recurrence a Python
    loop)."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x, dt, Bm, Cm = (kops._pad_seq(t, pad) for t in (x, dt, Bm, Cm))
    Lp = L + pad
    nc = Lp // Q
    xc = x.reshape(B, nc, Q, H, P)
    dtc = dt.reshape(B, nc, Q, H)
    Bc = Bm.reshape(B, nc, Q, H, N)
    Cc = Cm.reshape(B, nc, Q, H, N)
    y_diag, states, gamma = _ssd.ssd_chunk(xc, dtc, A, Bc, Cc)
    s = (torch.zeros((B, H, N, P), dtype=torch.float32)
         if initial_state is None
         else initial_state.transpose(-1, -2).float())
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * gamma[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prevs, dim=1)
    cs = torch.cumsum(dtc.float() * A.float(), dim=2)
    if Cc.stride(3) == 0:
        y_off = torch.einsum("bcin,bchnp->bcihp", Cc[:, :, :, 0].float(), prev)
    else:
        y_off = torch.einsum("bcihn,bchnp->bcihp", Cc.float(), prev)
    y_off = y_off * torch.exp(cs)[..., None]
    y = (y_diag.float() + y_off).reshape(B, Lp, H, P)[:, :L]
    return y.to(x.dtype), s.transpose(-1, -2).to(x.dtype)


def _leaves(*ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


def _assert_same(fn_new, fn_old, inputs):
    """Values and the gradients of every input, bit for bit."""
    a, b = _leaves(*inputs), _leaves(*inputs)
    outs_a, outs_b = fn_new(*a), fn_old(*b)
    outs_a = outs_a if isinstance(outs_a, tuple) else (outs_a,)
    outs_b = outs_b if isinstance(outs_b, tuple) else (outs_b,)
    for x, y in zip(outs_a, outs_b):
        assert torch.equal(x, y)
    gen = np.random.default_rng(7)
    cot = [torch.from_numpy(gen.standard_normal(tuple(o.shape))).to(o.dtype)
           for o in outs_a]
    ga = torch.autograd.grad(outs_a, a, cot, allow_unused=True)
    gb = torch.autograd.grad(outs_b, b, cot, allow_unused=True)
    for x, y in zip(ga, gb):
        assert (x is None and y is None) or torch.equal(x, y)


# ------------------------------------------------------- eager, bit for bit
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,sq,sk", [(True, 37, 37), (True, 32, 32),
                                          (False, 37, 37), (False, 12, 37)])
def test_blocked_attention_is_the_python_loop_bit_for_bit(causal, sq, sk,
                                                          dtype):
    """Blocks of 16: 37 keys leave a ragged last block of 5."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, h, 8))).to(dtype)
               for s, h in ((sq, 4), (sk, 2), (sk, 2)))
    _assert_same(lambda *a: blocked_attention(*a, causal=causal, block=16),
                 lambda *a: _previous_blocked(*a, causal=causal, block=16),
                 (q, k, v))


def _ssd_inputs(L, dtype, rng):
    B, H, P, G, N = 2, 4, 8, 1, 16
    x = torch.from_numpy(rng.standard_normal((B, L, H, P))).to(dtype)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, L, H))).float()
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (H,))).float()
    Bm = torch.from_numpy(rng.standard_normal((B, L, G, N))).to(dtype)
    Cm = torch.from_numpy(rng.standard_normal((B, L, G, N))).to(dtype)
    init = torch.from_numpy(rng.standard_normal((B, H, P, N))).to(dtype)
    return x, dt, A, Bm, Cm, init


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,initial", [(37, True), (32, False)])
def test_ssd_chunked_is_the_python_loop_bit_for_bit(monkeypatch, L,
                                                    initial, dtype):
    """The plain path at chunks of 8: 37 tokens leave a ragged last
    chunk."""
    x, dt, A, Bm, Cm, init = _ssd_inputs(L, dtype, np.random.default_rng(1))
    inputs = (x, dt, A, Bm, Cm) + ((init,) if initial else ())

    def new(*a):
        return ssm.ssd_chunked(*a[:5], 8, *a[5:])

    def old(*a):
        with monkeypatch.context() as m:
            m.setattr(ssm, "_recurrence", _previous_recurrence)
            return ssm.ssd_chunked(*a[:5], 8, *a[5:])
    _assert_same(new, old, inputs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,initial", [(37, True), (32, False)])
def test_the_kernel_paths_scan_is_the_python_loop_bit_for_bit(L, initial,
                                                             dtype):
    """``ops.ssd_scan`` on the CPU (K4 and K5's plain versions) at chunks
    of 8, B and C broadcast over the heads as ``apply_mamba`` passes
    them."""
    x, dt, A, Bm, Cm, init = _ssd_inputs(L, dtype, np.random.default_rng(2))
    H = x.shape[2]
    inputs = (x, dt.to(dtype), A, Bm, Cm) + ((init,) if initial else ())

    def run(scan):
        def fn(x, dt, A, Bm, Cm, *init):
            return scan(x, dt, A, ssm._heads(Bm, H), ssm._heads(Cm, H), 8,
                        *init)
        return fn
    _assert_same(run(kops.ssd_scan), run(_previous_ssd_scan), inputs)


# ------------------------------------------------------------ the captures
@pytest.mark.parametrize("arch,what", [
    ("chatglm3-6b", "train"), ("chatglm3-6b", "prefill"),
    ("whisper-large-v3", "train"), ("mamba2-1.3b", "train"),
    ("mamba2-1.3b", "prefill"), ("zamba2-1.2b", "prefill")])
def test_block_and_chunk_loops_equal_the_unrolled_capture(arch, what):
    """32 tokens in KV blocks of 8 and SSM chunks of 8: 4 of each a
    layer, 2 layers, a train step in 2 microbatches."""
    fn, args = step(arch, what, layers=2, micro=2, kv_block=8, chunk=8)
    unrolled = aten.capture(fn, *args)
    loops = aten.capture(fn, *fake(args), loops=True)
    _, prog = assert_equal_programs(unrolled, loops)
    assert len(loops.graph.nodes) < len(unrolled.graph.nodes)
    # the KV blocks' body stands for their 4 iterations, in training for 3
    # (the first is traced on its own: its carry starts without a
    # gradient); the chunks' for 3 and 2 (the last chunk's step follows
    # the loop); times the layers' and microbatches' trips
    layers = 1 if arch == "zamba2-1.2b" else 2      # zamba2: a Python loop
    micro = 2 if what == "train" else 1
    trips = {"train": 2, "prefill": 3} if arch == "mamba2-1.3b" else \
        {"train": 3, "prefill": 4}
    assert max(o.count for o in prog.ops) == micro * layers * trips[what]


@pytest.fixture
def mesh_2x2():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", [("whisper-large-v3", "train_4k"),
                                        ("mamba2-1.3b", "train_4k"),
                                        ("zamba2-1.2b", "prefill_32k")])
def test_mesh_cells_with_block_and_chunk_loops_equal_the_unrolled_ones(
        mesh_2x2, arch, shape):
    """On the (2, 2) fake mesh at 2 layers, a KV block of 1024 and an SSM
    chunk of 1024 (4 blocks and chunks at 4096 tokens; zamba2's prefill
    at 32k: 32 of each): whisper's K and V shard their sequence, gathered
    once before the blocks; mamba2's layer body counts 2 microbatches x
    2 layers."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prog = assert_loop_aware_cell_equals_unrolled(
            cell_at_depth(arch, shape, mesh_2x2, layers=2, chunk=1024))
    counts = {o.count for o in prog.ops}
    if arch == "mamba2-1.3b":        # 4 chunks: 2 in the loop's body
        assert counts == {1, 2, 2 * 2, 2 * 2 * 2}
    elif arch == "whisper-large-v3":  # 4 KV blocks: 3 in the body
        assert 2 * 2 * 3 in counts and 2 * 2 in counts
    else:     # 32 KV blocks in one body (their carry is made on q's
        # placements, so the first block's is the others'), and 31 chunks
        # in the loop
        assert counts == {1, 31, 32}
