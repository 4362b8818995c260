"""The next-token loss on each rank's shard (``models.layers``:
``next_token_loss`` of a DTensor runs ``sharded_next_token_loss``).

* Without a mesh the loss is the previous formula's, bit for bit, value
  and gradient (the formula as it stood is copied here, ``_previous``).
* On a (2, 2) fake mesh (torch's fake process group: nothing runs), the
  loss of logits sharded as the rules shard them (batch on 'data', the
  vocabulary or, on the sequence-parallel archs, the sequence on
  'model') captures no tensor at the global batch and the whole
  vocabulary, and its ``memory_analysis`` temp bytes fall by at least the
  f32 (B, S - 1, V) buffer that the previous formula's backward filled.
* On the reduced (2, 2) fake-mesh train cells of chatglm3-6b, mamba2-1.3b
  (tied head) and qwen1.5-32b (sequence-parallel) at 2 layers and 2
  microbatches: no captured node holds a tensor whose first two dims are
  a (micro)batch and S - 1 and whose last dim is the padded vocabulary,
  and no vocabulary-wide tensor is larger than a rank's (micro)batch
  rows x (S - 1) x V in f32.
* On gloo meshes (1, 2) (twice: ranks 0-1 and 2-3) and (2, 2), reduced
  chatglm3-6b, mamba2-1.3b and qwen1.5-32b (its sequence-parallel rules)
  at a vocabulary of 500 (padded to 512, so padded columns sit on the
  last rank's shard): ``LM.loss_fn`` and the gradient of every parameter
  equal the no-mesh ones at rtol 1e-4 (a gradient element also within
  1e-4 of its leaf's largest magnitude: the mesh reorders the sums).
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from _mesh_workers import loss_cases, loss_grad, spawn
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.core import aten
from repro_torch.models.layers import next_token_loss
from repro_torch.parallel.sharding import lsc, make_rules, use_rules

B, S, V = 8, 33, 512


def _previous(logits, tokens):
    """``next_token_loss`` as it stood before the loss was sharded."""
    lg = lsc(logits[:, :-1].float(), "batch", "rseq", None)
    tg = tokens[:, 1:]
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tg[..., None].long())[..., 0]
    return (lse - picked).mean()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_no_mesh_loss_is_the_previous_formula_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((B, S, V)) * 3).to(dtype)
    tokens = torch.from_numpy(rng.integers(0, 500, (B, S)))
    got_x = logits.clone().requires_grad_(True)
    want_x = logits.clone().requires_grad_(True)
    got = next_token_loss(got_x, tokens, 500)
    want = _previous(want_x, tokens)
    assert torch.equal(got, want)
    got.backward()
    want.backward()
    assert torch.equal(got_x.grad, want_x.grad)


@pytest.fixture
def fake_mesh():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _is_loss_buffer(t, batches, seq, vocab) -> bool:
    return (isinstance(t, torch.Tensor) and t.ndim >= 3
            and t.shape[0] in batches and t.shape[1] == seq
            and t.shape[-1] == vocab)


def _node_tensors(gm):
    for n in gm.graph.nodes:
        v = n.meta.get("val")
        for t in v if isinstance(v, (list, tuple)) else [v]:
            if isinstance(t, torch.Tensor):
                yield n, t


@pytest.mark.parametrize("layout", ["vocab", "sequence"])
def test_the_loss_on_a_mesh_allocates_a_ranks_share(fake_mesh, layout):
    """The loss and its gradient captured on the (2, 2) mesh, the logits
    (64, 64, 512) sharded as the rules shard them (``layout``: the
    vocabulary on 'model', or the sequence, as 'rseq' on the
    sequence-parallel archs): the previous formula's backward fills an f32
    (64, 63, 512) buffer; the sharded loss holds nothing at the global
    batch and vocabulary, and its temp bytes are lower by more than that
    buffer."""
    from repro_torch.launch.cell import SP_ACT_RULES, capture_on_mesh
    Bg, Sg = 64, 64
    mesh = fake_mesh
    act = SP_ACT_RULES if layout == "sequence" else None
    rules = make_rules(mesh, None, act)
    pls = rules.act_placements(("batch", "rseq", "vocab"), (Bg, Sg, V))
    assert pls == ((Shard(0), Shard(2)) if layout == "vocab"
                   else (Shard(0), Shard(1)))
    local = ((Bg // 2, Sg, V // 2) if layout == "vocab"
             else (Bg // 2, Sg // 2, V))
    tok_pl = rules.act_placements(("batch", "seq"), (Bg, Sg))

    def step(formula):
        def fn(x, tok):
            with use_rules(rules):
                lg = DTensor.from_local(x, mesh, pls, run_check=False,
                                        shape=torch.Size((Bg, Sg, V)),
                                        stride=(Sg * V, V, 1))
                tk = DTensor.from_local(tok, mesh, tok_pl, run_check=False,
                                        shape=torch.Size((Bg, Sg)),
                                        stride=(Sg, 1))
                loss = formula(lg, tk)
                g, = torch.autograd.grad(loss, [lg])
                return loss.to_local(), g.redistribute(mesh, pls).to_local()
        return fn

    x = torch.randn(local).requires_grad_(True)
    tok = torch.randint(0, 500, (Bg // 2, Sg))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        old = capture_on_mesh(step(_previous), x, tok)
        new = capture_on_mesh(
            step(lambda lg, tk: next_token_loss(lg, tk, 500)), x, tok)
    buffer = Bg * (Sg - 1) * V * 4
    assert any(_is_loss_buffer(t, (Bg,), Sg - 1, V)
               for _, t in _node_tensors(old))
    assert not any(_is_loss_buffer(t, (Bg,), Sg - 1, V)
                   for _, t in _node_tensors(new))
    share = (Bg // 2) * (Sg - 1) * V * 4
    assert max(t.numel() * t.element_size() for _, t in _node_tensors(new)
               if t.ndim and t.shape[-1] in (V, V // 2)) <= share
    t_old = aten.memory_analysis(old)["temp_bytes"]
    t_new = aten.memory_analysis(new)["temp_bytes"]
    assert t_old - t_new >= buffer, (t_old, t_new, buffer)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mamba2-1.3b",
                                  "qwen1.5-32b"])
def test_no_reduced_train_cell_holds_a_global_loss_buffer(fake_mesh, arch):
    from _loops import cell_at_depth
    c = cell_at_depth(arch, "train_4k", fake_mesh, layers=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gm = c.capture()
    cfg = c.model.cfg
    Bg, Sg, Vp = c.shape.global_batch, c.shape.seq_len, cfg.padded_vocab
    micro = c.run.microbatch
    assert micro and micro < Bg
    tensors = list(_node_tensors(gm))
    bad = [(n.name, tuple(t.shape)) for n, t in tensors
           if _is_loss_buffer(t, (Bg, micro), Sg - 1, Vp)]
    assert not bad, bad
    share = (micro // 2) * (Sg - 1) * Vp * 4
    wide = [t for n, t in tensors if t.ndim == 3 and t.shape[1] in
            (Sg, Sg - 1, Sg // 2) and t.shape[-1] in (Vp, Vp // 2)]
    assert wide and max(t.numel() * t.element_size() for t in wide) <= share


CASES = [("chatglm3-6b", None), ("mamba2-1.3b", None),
         ("qwen1.5-32b", "sp")]
MESHES = ["1x2", "1x2b", "2x2"]


def _cfg(arch):
    return dataclasses.replace(reduced_config(ARCHS[arch]), n_layers=2,
                               vocab_size=500)


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    from repro_torch.launch.cell import SP_ACT_RULES
    tmp = tmp_path_factory.mktemp("loss_shard")
    tokens = np.random.default_rng(1).integers(0, 500, (4, 32))
    np.save(tmp / "tokens.npy", tokens)
    cases = [(arch, _cfg(arch), SP_ACT_RULES if sp else None,
              tmp / "tokens.npy") for arch, sp in CASES]
    got = {}
    for r in spawn(loss_cases, 4, tmp, cases):
        got.update(r)
    from repro_torch.models.lm import build_model
    for arch, cfg, _, _ in cases:
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        got[(arch, None)] = loss_grad(cfg, params, tokens, None)
    return got


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", [a for a, _ in CASES])
def test_the_mesh_loss_and_gradient_equal_the_no_mesh_ones(gloo_results,
                                                           arch, mesh):
    loss, grads = gloo_results[(arch, mesh)]
    want_loss, want = gloo_results[(arch, None)]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    assert grads.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
