"""``core.aten.memory_analysis``: the dry-run's memory a rank.

* Liveness on small graphs with known peaks: a chain, a view that keeps
  a dead base alive, an in-place ``add_``, a donated input returned
  updated.
* For all 64 cells (32 on each production mesh), the argument bytes the
  analysis would find (``Cell.argument_bytes``: each tensor input's local
  shard under its placements) equal the local-shard bytes of the
  reference's abstract inputs under its ``MeshRules`` on a duck-typed
  mesh, built as ``tests/test_torch_cell.py`` builds them (a token is
  torch's int64 where the reference's is int32; a decode step's position
  is a Python int in the port, a 0-d input in the reference).  On a
  reduced-width capture they equal the placeholders' bytes.
"""
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.fx.experimental.proxy_tensor import make_fx

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.launch import cell as jcell
from repro.models import params as jpr
from repro.models.lm import build_model as j_build
from repro.parallel.sharding import make_rules as j_make_rules
from repro.serve.kvcache import cache_abstract as j_cache_abstract
from repro.train import optimizer as jopt
from repro_torch.core import aten
from repro_torch.launch import cell
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.dryrun import capture

N, K = 1000, 100


def _mem(fn, *args, donated=None):
    return aten.memory_analysis(make_fx(fn)(*args), donated=donated)


def test_a_chain_holds_two_intermediates_at_once():
    m = _mem(lambda x: ((x * 2) + 1) * 3, torch.zeros(N))
    assert m == {"argument_bytes": 4 * N, "output_bytes": 4 * N,
                 "temp_bytes": 8 * N, "alias_bytes": 0.0,
                 "peak_bytes_est": 16 * N}


def test_a_view_keeps_its_dead_base_alive():
    def f(x):
        y = x * 2
        w = y[:K] * 3          # reads y through a view; y dies after it
        return w + 1
    m = _mem(f, torch.zeros(N))
    assert (m["temp_bytes"], m["output_bytes"]) == (4 * N + 4 * K, 4 * K)


def test_an_in_place_write_allocates_nothing():
    def f(x):
        y = x * 2
        y.add_(1)
        return y * 3
    gm = make_fx(f)(torch.zeros(N))
    assert any("add_" in str(n.target) for n in gm.graph.nodes)
    assert aten.memory_analysis(gm)["temp_bytes"] == 4 * N


def test_a_donated_input_returned_updated_is_aliased():
    m = _mem(lambda x, y: x + y, torch.zeros(N), torch.zeros(N), donated=[0])
    assert (m["alias_bytes"], m["peak_bytes_est"]) == (4 * N, 8 * N)

    def write(c, v):           # a cache written in place and returned
        c[:K].copy_(v)
        return c
    m = _mem(write, torch.zeros(N), torch.zeros(K), donated=[0])
    assert m == {"argument_bytes": 4 * N + 4 * K, "output_bytes": 4 * N,
                 "temp_bytes": 0.0, "alias_bytes": 4 * N,
                 "peak_bytes_est": 4 * N + 4 * K}
    # not donated: the output is a buffer of its own
    assert _mem(write, torch.zeros(N), torch.zeros(K))["alias_bytes"] == 0


class DuckMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _local_bytes(shape, dtype, spec, sizes) -> float:
    local = list(shape)
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                local[d] //= sizes[axis]
    return math.prod(local) * jnp.dtype(dtype).itemsize


def _reference_argument_bytes(arch, shape, sizes) -> float:
    """The reference's abstract inputs, each at its local shard's bytes
    (tokens at torch's int64, a decode step's position left out)."""
    jshape = JSHAPES[shape]
    act = (jcell.SP_ACT_RULES if arch in jcell.SP_ARCHS
           and jshape.kind != "decode" else None)
    jr = j_make_rules(DuckMesh(sizes), None, act)
    kv = ("int8" if arch in jcell.KV_INT8_ARCHS and jshape.kind == "decode"
          else "bf16")
    jm = j_build(JARCHS[arch], ssd_impl="jnp", kv_cache_dtype=kv)
    jrun = jcell.default_run_config(JARCHS[arch], jshape)
    pdt = jnp.dtype(jrun.param_dtype)
    pspecs = jm.param_specs()
    total = 0.0
    leaves = _flat(jpr.abstract(pspecs, pdt))
    for k, p in _flat(pspecs).items():
        total += _local_bytes(p.shape, leaves[k].dtype,
                              jr.param_spec(p.axes, p.shape), sizes)
    if jshape.kind == "train":
        ocfg = jopt.OptConfig(name=JARCHS[arch].optimizer,
                              weight_decay=jrun.weight_decay,
                              grad_clip=jrun.grad_clip)
        ospecs = jopt.state_spec_tree(JARCHS[arch].optimizer, pspecs, ocfg)
        odt = jnp.dtype(jrun.optimizer_dtype)
        for field in ospecs:
            for k, p in _flat(field).items():
                total += _local_bytes(p.shape, odt,
                                      jr.param_spec(p.axes, p.shape), sizes)
    B, S = jshape.global_batch, jshape.seq_len
    if jshape.kind == "decode":
        cache = _flat(j_cache_abstract(jm, B, S, pdt))
        for k, p in _flat(jm.cache_specs(B, S)).items():
            total += _local_bytes(p.shape, cache[k].dtype,
                                  jr.act_spec(p.axes, p.shape), sizes)
    axes = jm.batch_logical_axes(jshape)
    for k, ref in jm.input_specs(jshape, pdt).items():
        if k == "pos":
            continue
        dt = np.int64 if k == "tokens" else ref.dtype
        total += _local_bytes(ref.shape, dt,
                              jr.act_spec(axes.get(k, ()), tuple(ref.shape)),
                              sizes)
    return total


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_argument_bytes_equal_the_reference_for_every_cell(mesh_name):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    sizes = MESHES[mesh_name]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(sizes.values()))
    try:
        mesh = lmesh.make_production_mesh(multi_pod="pod" in sizes,
                                          device_type="cpu")
        got = {(a, s): cell.build_cell(a, s, mesh).argument_bytes()
               for a, s in jcell.all_cells()}
    finally:
        dist.destroy_process_group()
    want = {(a, s): _reference_argument_bytes(a, s, sizes)
            for a, s in jcell.all_cells()}
    assert len(got) == 32 and got == want


@pytest.mark.parametrize("arch,shape", [("chatglm3-6b", "decode_32k"),
                                        ("chatglm3-6b", "prefill_32k")])
def test_argument_bytes_equal_the_captured_placeholders(arch, shape):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cap = capture(arch, shape, mesh_shape=(2, 2), reduced=True)
    mem = aten.memory_analysis(cap["gm"])
    assert mem["argument_bytes"] == cap["cell"].argument_bytes() > 0
    inputs = [n for n in cap["gm"].graph.nodes if n.op == "placeholder"]
    donated = [n.meta["donated"] for n in inputs]
    assert any(donated) == (cap["cell"].kind == "decode")
