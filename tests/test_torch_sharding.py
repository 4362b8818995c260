"""The port's ``MeshRules`` against the reference's, entry for entry.

Both packages resolve the same logical axes on the same meshes: the
duck-typed meshes of ``zoo.mesh_rules_resolver`` (``axis_names``,
``devices.shape``; the reference's ``MeshRules`` is pure Python on them),
and for the port also a torch ``DeviceMesh`` of the same shape over torch's
fake process group (no process, no device).  Covered: every leaf of the ten
architectures' full-width ``param_specs()`` and ``cache_specs()``, each
model input's ``batch_logical_axes``, on (16, 16), (2, 16, 16) and (1, tp)
for tp in 1-16; the reference's own rule tests
(``tests/test_data_optim_sharding.py``) as cases; the spec-to-placements
map; and ``launch.mesh.make_production_mesh`` over fake worlds of 256 and
512 ranks.
"""
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as JARCHS
from repro.configs import ShapeConfig as JShapeConfig
from repro.models.lm import build_model as j_build
from repro.parallel.sharding import MeshRules as JMeshRules
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.models import params as pr
from repro_torch.models.lm import build_model
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import MeshRules

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          **{f"1x{tp}": {"data": 1, "model": tp} for tp in (1, 2, 4, 8, 16)}}


class DuckMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


@pytest.fixture
def fake_world():
    """torch's fake process group of 512 ranks, for DeviceMeshes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield
    dist.destroy_process_group()


def _device_mesh(sizes):
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(list(sizes.values())))
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(sizes.values())),
                      mesh_dim_names=tuple(sizes))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _pairs(jtree, ttree):
    """The port's spec leaves, each checked against the reference's leaf of
    the same path."""
    jl, tl = _flat(jtree), _flat(ttree)
    assert jl.keys() == tl.keys()
    for k in jl:
        assert (jl[k].shape, jl[k].axes) == (tl[k].shape, tl[k].axes), k
    return list(tl.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference_entry_for_entry(arch, mesh, fake_world):
    sizes = MESHES[mesh]
    jr = JMeshRules(DuckMesh(sizes))
    rules = [MeshRules(DuckMesh(sizes)), MeshRules(_device_mesh(sizes))]
    jm, tm = j_build(JARCHS[arch]), build_model(ARCHS[arch])
    for p in _pairs(jm.param_specs(), tm.param_specs()):
        want = tuple(jr.param_spec(p.axes, p.shape))
        for r in rules:
            assert r.param_spec(p.axes, p.shape) == want, (p.axes, p.shape)
    for batch, seq in ((1, 524288), (32, 32768)):
        for p in _pairs(jm.cache_specs(batch, seq),
                        tm.cache_specs(batch, seq)):
            want = tuple(jr.act_spec(p.axes, p.shape))
            for r in rules:
                assert r.act_spec(p.axes, p.shape) == want, (p.axes, p.shape)
    for kind, (seq, batch) in (("train", (4096, 256)),
                               ("decode", (32768, 128))):
        js = jm.input_specs(JShapeConfig("s", seq, batch, kind))
        ts = tm.input_specs(ShapeConfig("s", seq, batch, kind))
        ja = jm.batch_logical_axes(JShapeConfig("s", seq, batch, kind))
        ta = tm.batch_logical_axes(ShapeConfig("s", seq, batch, kind))
        assert ja == ta and js.keys() == ts.keys()
        for k in js:
            shape = tuple(js[k].shape)
            assert tuple(getattr(ts[k], "shape", ())) == shape
            want = tuple(jr.act_spec(ja.get(k, ()), shape))
            for r in rules:
                assert r.act_spec(ta.get(k, ()), shape) == want, k


def _rules_for(sizes):
    return MeshRules(DuckMesh(sizes)), JMeshRules(DuckMesh(sizes))


# the reference's rule tests (tests/test_data_optim_sharding.py), each a
# case: (mesh, param or act, axes, shape, expected spec)
RULE_CASES = [
    ({"data": 16, "model": 16}, "param", ("embed", "mlp"), (8192, 32768),
     ("data", "model")),
    ({"data": 16, "model": 16}, "param", ("embed", "heads", "head_dim"),
     (5120, 40, 128), ("data", None, "model")),
    ({"data": 16, "model": 16}, "act",
     ("batch", "kvseq", "kv_heads", "head_dim"), (128, 32768, 8, 128),
     ("data", "model", None, None)),
    ({"pod": 2, "data": 16, "model": 16}, "act", ("batch",), (256,),
     (("pod", "data"),)),
    ({"pod": 2, "data": 16, "model": 16}, "act", ("batch", "kvseq"),
     (1, 524288), (None, ("model", "data"))),
    ({"pod": 2, "data": 16, "model": 16}, "act", ("batch",), (2,),
     ("pod",)),
    ({"data": 8, "model": 4}, "act", ("batch", "seq", "heads", "head_dim"),
     (256, 4096, 20, 128), ("data", None, "model", None)),
]


@pytest.mark.parametrize("sizes,kind,axes,shape,want", RULE_CASES)
def test_reference_rule_cases(sizes, kind, axes, shape, want):
    r, jr = _rules_for(sizes)
    fn = r.param_spec if kind == "param" else r.act_spec
    jfn = jr.param_spec if kind == "param" else jr.act_spec
    assert fn(axes, shape) == want
    assert tuple(jfn(axes, shape)) == want


AXES_POOL = ["batch", "seq", "rseq", "heads", "kv_heads", "head_dim", "mlp",
             "embed", "vocab", "kvseq", "experts", None]
DIMS_POOL = [1, 2, 8, 16, 40, 64, 128, 256, 4096, 32768]
SIZES_POOL = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
              {"data": 8, "model": 4}, {"data": 1, "model": 1}]


@pytest.mark.parametrize("seed", range(8))
def test_random_axes_and_shapes_match_reference_and_stay_safe(seed):
    """The reference's property tests on a seeded grid (120 draws a
    seed): the port's spec equals the reference's, no mesh axis is used
    twice, every assignment divides its dim, and activations never shard
    head_dim."""
    rng = np.random.default_rng(seed)
    for _ in range(120):
        sizes = SIZES_POOL[rng.integers(len(SIZES_POOL))]
        n = int(rng.integers(1, 5))
        axes = tuple(AXES_POOL[i] for i in rng.integers(len(AXES_POOL),
                                                        size=n))
        dims = tuple(int(DIMS_POOL[i]) for i in rng.integers(len(DIMS_POOL),
                                                            size=n))
        r, jr = _rules_for(sizes)
        for fn, jfn in ((r.act_spec, jr.act_spec),
                        (r.param_spec, jr.param_spec)):
            spec = fn(axes, dims)
            assert spec == tuple(jfn(axes, dims)), (sizes, axes, dims)
            used = []
            for d, a in zip(dims, spec):
                names = () if a is None else (a,) if isinstance(a, str) \
                    else a
                assert not set(names) & set(used), spec
                used += names
                assert d % int(np.prod([sizes[m] for m in names])) == 0
        assert r.act_spec(("batch", "seq", "heads", "head_dim"),
                          (256, 4096, 20, 128))[3] is None


def test_rules_cover_all_logical_axes():
    for cfg in ARCHS.values():
        model = build_model(cfg)
        for leaf in pr.leaves(model.param_specs()):
            assert all(a is None or a in sh.PARAM_RULES for a in leaf.axes)
        for leaf in pr.leaves(model.cache_specs(2, 8)):
            assert all(a is None or a in sh.ACT_RULES for a in leaf.axes)


def test_placements_shard_in_mesh_order_and_skip_size_one(fake_world):
    mesh = _device_mesh({"pod": 2, "data": 16, "model": 16})
    assert sh.placements_of((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements_of((None, ("model", "data")), mesh) == (
        Replicate(), Shard(1), Shard(1))
    one = _device_mesh({"data": 1, "model": 2})
    r = MeshRules(one)
    assert r.param_spec(("embed", "mlp"), (64, 128)) == ("data", "model")
    assert r.param_placements(("embed", "mlp"), (64, 128)) == (
        Replicate(), Shard(1))


def test_lsc_is_a_no_op_outside_rules_and_on_plain_tensors():
    x = torch.ones(4, 8)
    assert sh.lsc(x, "batch", "embed") is x
    with sh.use_rules(MeshRules(DuckMesh({"data": 2, "model": 1}))):
        assert sh.current_rules() is not None
        assert sh.lsc(x, "batch", "embed") is x
        assert sh.lsc_param(x, "embed", "mlp") is x
    assert sh.current_rules() is None


@pytest.mark.parametrize("world,multi_pod", [(256, False), (512, True),
                                             (512, False)])
def test_make_production_mesh_over_a_fake_world(world, multi_pod):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mesh = lmesh.make_production_mesh(multi_pod=multi_pod,
                                              device_type="cpu")
        want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                else {"data": 16, "model": 16})
        assert lmesh.mesh_axis_sizes(mesh) == want
        assert lmesh.n_chips(mesh) == int(np.prod(list(want.values())))
        idle = [x for x in w if "idle" in str(x.message)]
        assert len(idle) == (1 if lmesh.n_chips(mesh) < world else 0)
        if world == 256:
            with pytest.raises(RuntimeError, match="need 512 devices"):
                lmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    finally:
        dist.destroy_process_group()


class _Spec:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("dims,want", [([1], {0, 2}), ([-1], {0, 1}),
                                       ([0, 2], {1})])
def test_flip_strategy_never_shards_a_flipped_dim(dims, want):
    """The strategies registered where torch lacks one (torch 2.11 on the
    card: ``flip``, ``softplus`` and its backward): replicated, or sharded
    alike on a dim the op does not reverse; never partial."""
    flip = sh._pointwise_strategy(1, lambda args, ndim: {
        d % ndim for d in args[1]})
    got = flip(_Spec((4, 6, 8)), dims)
    assert got[0] == ([Replicate()], [Replicate(), None])
    assert {o[0].dim for o, _ in got[1:]} == want
    assert all(o == i[:1] and i[1] is None for o, i in got[1:])
    soft_bwd = sh._pointwise_strategy(2, lambda args, ndim: ())
    got = soft_bwd(_Spec((4, 6)), _Spec((4, 6)), 1.0, 20.0)
    assert got == [([Replicate()], [Replicate()] * 2 + [None] * 2),
                   ([Shard(0)], [Shard(0)] * 2 + [None] * 2),
                   ([Shard(1)], [Shard(1)] * 2 + [None] * 2)]


def test_missing_strategies_are_not_registered_over_torchs_own():
    """The torch here has flip and softplus's: only constant_pad_nd, which
    is replaced on every torch, is registered; its strategy keeps the
    padded dims whole."""
    assert sh.register_missing_strategies() == [
        "aten.constant_pad_nd.default"]
    pad = sh._pointwise_strategy(1, sh._padded_dims)
    got = pad(_Spec((2, 5, 7, 3)), [0, 0, 1, 2], 0.0)
    assert {o[0].dim for o, _ in got[1:]} == {0, 1, 3}
    assert got[0] == ([Replicate()], [Replicate(), None, None])


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mamba2-1.3b"])
def test_serve_shardings_place_a_decode_cell_by_the_rules(arch, fake_world):
    """``serve_shardings``' three trees: each parameter, cache leaf and
    batch input placed as its reference spec says on (16, 16)."""
    from repro_torch.serve.engine import serve_shardings
    sizes = MESHES["16x16"]
    mesh = _device_mesh(sizes)
    jr, rules = JMeshRules(DuckMesh(sizes)), MeshRules(mesh)
    jm, tm = j_build(JARCHS[arch]), build_model(ARCHS[arch])
    shape = ShapeConfig("d", 32768, 128, "decode")
    p_sh, c_sh, b_sh = serve_shardings(tm, shape, rules)
    for got, p in zip(_flat(p_sh).values(),
                      _pairs(jm.param_specs(), tm.param_specs())):
        assert got == sh.placements_of(jr.param_spec(p.axes, p.shape), mesh)
    for got, p in zip(_flat(c_sh).values(),
                      _pairs(jm.cache_specs(128, 32768),
                             tm.cache_specs(128, 32768))):
        assert got == sh.placements_of(jr.act_spec(p.axes, p.shape), mesh)
    assert b_sh == {"tokens": (Shard(0), Replicate()),
                    "pos": (Replicate(), Replicate())}
