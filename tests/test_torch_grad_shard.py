"""A stacked weight's gradient reduced into its FSDP shard inside the layer
loop (``core.aten.grad_in_placements``), and the blocked attention's
initial carry made where q lives (``models.attention._initial_carry``).

* A small stacked loop on a (2, 2) fake mesh (torch's fake process group:
  nothing runs): each layer's gradient, a partial sum over 'data', is
  reduce-scattered into the slice's shard in the loop's backward (its
  collectives carry ``grad_of`` and count the loop's trips), the stacked
  gradient is the rank's shard, and the loop-aware capture equals the
  unrolled one.  A plain tensor, one without a gradient and a DTensor on
  a mesh of one rank pass through as they are.
* The reduced ``train_4k`` cells of chatglm3-6b, nemotron-4-340b,
  grok-1-314b (its experts) and mamba2-1.3b (tied head) on the (2, 2)
  fake mesh at 3 layers and 2 microbatches: no captured node holds a
  stacked parameter's gradient in f32 at more than a rank's shard of that
  parameter, each stacked gradient leaves the layer loop as the rank's
  shard (the stack of its slices has the shard's local shape and is cast
  to f32 with no collective between), and each stacked parameter's
  reduction in the loop counts n_micro x n_layers.
* The reduced train cells of whisper-large-v3, qwen1.5-32b and
  paligemma-3b on a (2, 2, 2) ('pod', 'data', 'model') fake mesh: the
  blocked attention's initial m, l and acc allocate a rank's rows of the
  microbatch, not its global batch.
* Without a mesh the train step is the previous formula's bit for bit
  (the step as it stood is copied here, ``_previous_step``: gradients
  cast to f32 whole, accumulated, averaged, clipped, AdamW), with 1 and 2
  microbatches, and the blocked attention's initial carry is the previous
  ``torch.full``/``torch.zeros`` (``test_torch_aten_loops_blocks.py``
  holds the whole function bit for bit).
"""
import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _loops import assert_equal_programs, cell_at_depth, fake
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.core import aten
from repro_torch.launch.cell import capture_on_mesh
from repro_torch.launch.dryrun import collective_nodes, grad_collectives
from repro_torch.models import params as pr
from repro_torch.models.attention import NEG_INF, blocked_attention
from repro_torch.models.lm import build_model
from repro_torch.parallel.sharding import (MeshRules, contiguous_stride,
                                          use_rules)
from repro_torch.train.optimizer import (OptConfig, clip_by_global_norm,
                                         make_optimizer)
from repro_torch.train.trainer import make_train_step

LAYERS = 3


def _fake_mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


@pytest.fixture
def mesh_2x2():
    try:
        yield _fake_mesh((2, 2), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.fixture
def mesh_pod():
    try:
        yield _fake_mesh((2, 2, 2), ("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def _capture(c):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return c.capture()


# ------------------------------------------------- a small stacked loop
def _loop_step(mesh, L=5, d=16, rows=8, keep=()):
    """(fn, args): h (rows, d) sharded on 'data' through L layers of a
    stacked (L, d, d) weight sharded on 'data' along its rows (gathered in
    the layer); returns the weight's gradient (its local tensor), which
    each layer's backward gives as a partial sum over 'data'.  With
    ``keep`` (mesh dims) the layers run under rules whose
    ``keep_grad_dims`` they are."""
    w_pl = (Shard(1), Replicate())          # the slices' Shard(0)
    h_pl = (Shard(0), Replicate())

    def fn(w_local, h_local):
        w = DTensor.from_local(w_local, mesh, w_pl, run_check=False,
                               shape=torch.Size((L, d, d)),
                               stride=(d * d, d, 1)).requires_grad_(True)
        h = DTensor.from_local(h_local, mesh, h_pl, run_check=False,
                               shape=torch.Size((rows, d)), stride=(d, 1))

        def body(h, i, wi):
            return torch.tanh(h @ wi["w"]).redistribute(mesh, h_pl), None
        with use_rules(MeshRules(mesh, keep_grad_dims=keep)):
            out, _ = aten.repeat(body, L, h, xs=({"w": w},))
        g, = torch.autograd.grad(out.to_local().sum(), [w])
        want = (g.placements[0],) + w_pl[1:] if keep else w_pl
        assert tuple(g.placements) == want
        return g.to_local()
    return fn, (torch.randn(L, d // 2, d), torch.randn(rows // 2, d))


def _both(fn, args):
    """(unrolled, loop-aware) captures of ``fn`` as ``Cell.capture`` takes
    them (``capture_on_mesh``: without torch 2.11's shape-propagation ops
    on empty global tensors)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return capture_on_mesh(fn, *args), capture_on_mesh(
            fn, *fake(args), loops=True)


def test_each_layers_gradient_is_reduced_in_the_loop(mesh_2x2):
    L, d = 5, 16
    unrolled, loops = _both(*_loop_step(mesh_2x2, L, d))
    pu, pl = aten.parse_graph(unrolled), aten.parse_graph(loops)
    assert pl.comm_bytes == pu.comm_bytes > 0
    for gm in (unrolled, loops):
        grads = [c for c in collective_nodes(gm) if c["grad_of"] == "w"]
        rs = [c for c in grads if c["opcode"] == "reduce-scatter"]
        assert sum(c["count"] for c in rs) == L
        assert all(c["dtype"] == "f32" for c in grads)
        out = [n for n in gm.graph.nodes if n.op == "output"][0]
        assert tuple(out.args[0].meta["val"].shape) == (L, d // 2, d)
    # loop-aware: the first layer on its own (its carry gains a
    # gradient), the body the other L - 1, each reduction in the body's
    # backward
    counts = {c["count"] for c in collective_nodes(loops)
              if c["grad_of"] == "w"}
    assert counts == {1, L - 1}
    assert set(grad_collectives(collective_nodes(loops))) == {"1", f"{L - 1}"}
    assert all(c["backward"] for c in collective_nodes(loops)
               if c["grad_of"] == "w" and c["count"] > 1)


def test_kept_mesh_dims_are_not_reduced_in_the_loop(mesh_2x2):
    """Under rules with ``keep_grad_dims=(0,)`` the gradient stays a
    partial sum over 'data' (the trainer's cross-pod compression syncs
    'pod' so)."""
    unrolled, loops = _both(*_loop_step(mesh_2x2, keep=(0,)))
    for gm in (unrolled, loops):
        assert not [c for c in collective_nodes(gm) if c["grad_of"] and
                    c["opcode"] in ("reduce-scatter", "all-reduce")]


def test_what_needs_no_reduction_passes_through(mesh_2x2):
    from torch.distributed.device_mesh import DeviceMesh
    x = torch.randn(3, 4, requires_grad=True)
    assert aten.grad_in_placements(x, "x") is x
    d = DTensor.from_local(torch.randn(3, 4), mesh_2x2,
                           [Replicate(), Shard(1)], run_check=False)
    assert aten.grad_in_placements(d) is d                 # no gradient
    one = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                     mesh_dim_names=("data", "model"))
    r = DTensor.from_local(torch.randn(3, 4), one, [Replicate()] * 2,
                           run_check=False).requires_grad_(True)
    assert aten.grad_in_placements(r) is r
    s = d.detach().requires_grad_(True)
    assert aten.grad_in_placements(s, "s") is not s


def _adafactor_step(mesh):
    """(fn, args): one ``adafactor_update`` of a (2, 128, 256) leaf whose
    gradient, parameter and row factor are sharded as FSDP and tensor
    parallelism shard them, and whose column factor arrives replicated."""
    from repro_torch.train.optimizer import (AdafactorState, OptConfig,
                                             adafactor_update)
    g_pl, vr_pl, rep = (Shard(1), Shard(2)), (Shard(1), Replicate()), \
        (Replicate(), Replicate())
    shape = (2, 128, 256)

    def dt(local, pl, shp):
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=torch.Size(shp),
                                  stride=contiguous_stride(shp))

    def fn(p, g, vr, vc):
        state = AdafactorState(step=torch.zeros((), dtype=torch.int32),
                               vr={"w": dt(vr, vr_pl, shape[:2])},
                               vc={"w": dt(vc, rep, (2, 256))},
                               v={"w": torch.zeros(1)})
        new_p, new_s = adafactor_update(
            {"w": dt(g, g_pl, shape)}, state, {"w": dt(p, g_pl, shape)},
            1e-3, OptConfig(name="adafactor"))
        return new_p["w"].to_local(), new_s.vc["w"].to_local()
    local = (2, 64, 128)
    return fn, (torch.randn(local), torch.randn(local),
                torch.rand(2, 64), torch.rand(2, 256))


def test_adafactors_second_moment_stays_on_the_gradients_shard(mesh_2x2):
    """Its outer product of the row and column factors, and every other
    3-d tensor of the update, hold a rank's (2, 64, 128) shard, however
    the column factor arrives; the new column factor takes the
    gradient's 'model' sharding."""
    fn, args = _adafactor_step(mesh_2x2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gm = capture_on_mesh(fn, *args)
    big = [(n.name, tuple(t.shape)) for n, t in _node_tensors(gm)
           if t.ndim == 3 and t.numel() > 2 * 64 * 128]
    assert not big, big
    out = [n for n in gm.graph.nodes if n.op == "output"][0]
    assert tuple(out.args[0][1].meta["val"].shape) == (2, 128)


# ------------------------------------------------- the reduced train cells
def _node_tensors(gm):
    for n in gm.graph.nodes:
        v = n.meta.get("val")
        for t in v if isinstance(v, (list, tuple)) else [v]:
            if isinstance(t, torch.Tensor):
                yield n, t


@pytest.mark.parametrize("arch", ["chatglm3-6b", "nemotron-4-340b",
                                  "grok-1-314b", "mamba2-1.3b"])
def test_stacked_gradients_stay_in_the_ranks_shard(mesh_2x2, monkeypatch,
                                                   arch):
    from repro_torch.train import trainer
    c = cell_at_depth(arch, "train_4k", mesh_2x2, layers=LAYERS)
    compute = getattr(torch, c.run.compute_dtype)
    stacked = pr.stacked_shards(c.model.param_specs(), c.rules)
    fulls = {full for full, local in stacked.values() if full != local}
    locals_ = {local for _, local in stacked.values()}
    # some stacked leaf is sharded, so a whole-shape gradient would show
    assert fulls and all(f[0] == LAYERS for f in fulls)
    # each gradient as the trainer receives it, before its f32 cast
    arrived = []
    real = trainer._redistribute

    def record(x, placements, keep=None):
        if placements is not None and x.dtype == compute \
                and tuple(x.shape) in {f for f, _ in stacked.values()}:
            arrived.append((tuple(x.shape), tuple(x.placements),
                            tuple(placements)))
        return real(x, placements, keep)
    monkeypatch.setattr(trainer, "_redistribute", record)
    gm = _capture(c)
    micro = c.shape.global_batch // c.run.microbatch
    # no captured node holds one in f32 at a shape the shard cuts
    bad = [(n.name, tuple(t.shape)) for n, t in _node_tensors(gm)
           if n.op != "placeholder" and t.dtype == torch.float32
           and tuple(t.shape) in fulls and tuple(t.shape) not in locals_]
    assert not bad, bad
    # every stacked leaf's gradient leaves the layer loop in the leaf's
    # placements
    assert len(arrived) >= len(stacked)
    assert all(got == want for _, got, want in arrived), arrived
    # the stacks of the gradient slices have the shards' local shapes
    stacks = [n for n in gm.graph.nodes if n.meta.get("loop_stack")
              and n.target == torch.ops.aten.view.default
              and n.meta["val"].ndim > 1
              and n.meta["val"].shape[0] == LAYERS]
    assert stacks and all(tuple(n.meta["val"].shape) in locals_
                          for n in stacks)
    # each leaf whose gradient needs a reduction is reduced in the layer
    # loop's backward (a first layer traced on its own: in its own), in
    # the compute dtype, once a layer instance
    grads = [g for g in collective_nodes(gm) if g["grad_of"] is not None]
    assert grads
    body = max(g["count"] for g in grads)
    assert body in (micro * LAYERS, micro * (LAYERS - 1))
    per = {}
    for g in grads:
        per[g["grad_of"]] = per.get(g["grad_of"], 0) + g["count"]
        assert g["dtype"] == aten.DTYPE_NAMES[compute]
        assert g["backward"] or g["count"] < body
    assert all(n % (micro * LAYERS) == 0 for n in per.values()), per


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen1.5-32b",
                                  "paligemma-3b"])
def test_the_blocked_attentions_carry_is_a_ranks_rows(mesh_pod, arch):
    c = cell_at_depth(arch, "train_4k", mesh_pod, layers=2)
    gm = _capture(c)
    rows = c.run.microbatch // 4                 # 'pod' x 'data'
    carries = [t for n, t in _node_tensors(gm)
               if n.target == torch.ops.aten.full.default
               and n.args[1] == NEG_INF and t.ndim == 4]
    accs = [t for n, t in _node_tensors(gm)
            if n.target == torch.ops.aten.full.default
            and t.ndim == 5 and t.dtype == torch.float32]
    assert carries and accs
    assert {t.shape[0] for t in carries + accs} == {rows}, \
        [tuple(t.shape) for t in carries + accs]


# ------------------------------------------------- without a mesh
def _previous_step(model, run, params, opt_state, batch):
    """The train step without a mesh as it stood: each gradient cast to
    f32 at once, microbatches accumulated in f32 and averaged."""
    cfg = model.cfg
    opt_cfg = OptConfig(name=cfg.optimizer, weight_decay=run.weight_decay,
                        grad_clip=run.grad_clip)
    _, opt_update, _ = make_optimizer(cfg.optimizer, opt_cfg)
    n_micro = run.microbatches()
    cparams = pr.tree_map(
        lambda p: p.detach().to(getattr(torch, run.compute_dtype))
        .requires_grad_(True), params)
    leaves = pr.leaves(cparams)

    def grads_of(b):
        loss, _ = model.loss_fn(cparams, b)
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)
    if n_micro == 1:
        loss, gs = grads_of(batch)
        grads = [g.float() for g in gs]
    else:
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        losses = []
        for i in range(n_micro):
            loss, gs = grads_of({k: v.chunk(n_micro)[i]
                                 for k, v in batch.items()})
            losses.append(loss)
            for a, g in zip(grads, gs):
                a.add_(g.float())
        grads = [g / n_micro for g in grads]
        loss = torch.stack(losses).mean()
    it = iter(grads)
    grads = pr.tree_map(lambda _: next(it), params)
    grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
    new_params, new_opt = opt_update(grads, opt_state, params,
                                     run.learning_rate)
    return new_params, new_opt, loss, gnorm


@pytest.mark.parametrize("micro", [1, 2])
def test_the_no_mesh_train_step_is_the_previous_formula(micro):
    cfg = dataclasses.replace(reduced_config(ARCHS["chatglm3-6b"]),
                              n_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 16, 4, "train"),
                    param_dtype="float32", compute_dtype="bfloat16",
                    microbatch=4 // micro)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 16)))
    step, *_, opt_init = make_train_step(model, run)
    got_p, got_o, m = step(params, opt_init(params), {"tokens": toks})
    want_p, want_o, loss, gnorm = _previous_step(
        model, run, params, opt_init(params), {"tokens": toks})
    assert torch.equal(m["loss"], loss) and torch.equal(m["grad_norm"], gnorm)
    for a, b in zip(pr.leaves(got_p) + pr.leaves(got_o.mu),
                    pr.leaves(want_p) + pr.leaves(want_o.mu)):
        assert torch.equal(a, b)


def test_the_no_mesh_carry_is_the_previous_allocation(monkeypatch):
    """The blocked attention without a mesh allocates its carry with the
    previous calls, so its values are the previous ones bit for bit."""
    made = []
    real_full = torch.full

    def full(*a, **k):
        made.append(("full", tuple(a[0]), a[1], k.get("dtype")))
        return real_full(*a, **k)
    monkeypatch.setattr(torch, "full", full)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 24, h, 8))).float()
               for h in (4, 2, 2))
    blocked_attention(q, k, v, causal=True, block=8)
    assert made == [("full", (2, 2, 2, 24), NEG_INF, torch.float32)]
