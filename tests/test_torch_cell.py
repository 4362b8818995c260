"""``launch.cell`` against the reference's ``repro.launch.cell``.

The reference's cells do not lower under the installed JAX (its
``with_sharding_constraint`` refuses Explicit mesh axes), so the parts that
do not lower are held entry for entry: the policy tables, ``all_cells``,
``model_flops_for`` and ``default_run_config`` for every cell, and, for
every cell on the (16, 16) and (2, 16, 16) production meshes, each
abstract input's shape and dtype and each placement, against the
reference's pieces (``params.abstract``, ``model.input_specs``,
``kvcache.cache_abstract``, the optimizer's ``state_spec_tree``, and
``MeshRules`` on a duck-typed mesh, with the cell's own rule overrides)
turned into DTensor placements as ``tests/test_torch_sharding.py`` does.
The port's cells are built on ``launch.mesh.make_production_mesh`` over
torch's fake process group of 256 or 512 ranks.

``Cell.capture()`` runs at reduced width on a (2, 2) mesh of 4 fake ranks
for a train, a prefill and a decode cell of chatglm3-6b and of
mamba2-1.3b; each capture is parsed and simulated.  The decode cell of
chatglm3-6b is held to a list of collectives derived by hand from the
redistributions its placements imply (``_embed``, ``_layer``, ``_head``).
"""
import dataclasses
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.launch import cell as jcell
from repro.models import params as jpr
from repro.models.lm import build_model as j_build
from repro.parallel.sharding import make_rules as j_make_rules
from repro.serve.kvcache import cache_abstract as j_cache_abstract
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, SHAPES, reduced_config
from repro_torch.core.aten import parse_graph
from repro_torch.core.hwspec import H100
from repro_torch.core.simulate import simulate
from repro_torch.launch import cell
from repro_torch.launch import mesh as lmesh
from repro_torch.parallel.sharding import placements_of


class DuckMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _world(n):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def test_policy_tables_equal():
    assert cell.TRAIN_MICROBATCH == jcell.TRAIN_MICROBATCH
    assert cell.SP_ARCHS == jcell.SP_ARCHS
    assert cell.KV_INT8_ARCHS == jcell.KV_INT8_ARCHS
    assert cell.SP_ACT_RULES == jcell.SP_ACT_RULES


def test_all_cells_equal():
    assert cell.all_cells() == jcell.all_cells()
    assert len(cell.all_cells()) == 32


@pytest.mark.parametrize("arch,shape", jcell.all_cells())
def test_run_config_and_model_flops_equal(arch, shape):
    run = cell.default_run_config(ARCHS[arch], SHAPES[shape])
    jrun = jcell.default_run_config(JARCHS[arch], JSHAPES[shape])
    assert dataclasses.asdict(run) == dataclasses.asdict(jrun)
    over = {"learning_rate": 1e-3, "microbatch": 8}
    assert dataclasses.asdict(cell.default_run_config(
        ARCHS[arch], SHAPES[shape], **over)) == dataclasses.asdict(
        jcell.default_run_config(JARCHS[arch], JSHAPES[shape], **over))
    assert cell.model_flops_for(ARCHS[arch], SHAPES[shape]) == \
        jcell.model_flops_for(JARCHS[arch], JSHAPES[shape])


def test_a_skipped_shape_is_refused_as_the_reference_refuses_it():
    mesh = DuckMesh(MESHES["16x16"])
    with pytest.raises(ValueError, match="long_500k is skipped"):
        cell.build_cell("chatglm3-6b", "long_500k", mesh)
    with pytest.raises(ValueError, match="long_500k is skipped"):
        jcell.build_cell("chatglm3-6b", "long_500k", mesh)


# ---------------------------------------------- inputs and placements
def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _fields(state):
    """An optimizer state's fields as flat dicts (a NamedTuple of trees)."""
    return {f"{name}/{k}": v for name in state._fields
            for k, v in _flat(getattr(state, name)).items()}


def _dtype(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    return jnp.dtype(x).name


def _check(port_abs, port_sh, ref_abs, ref_specs, spec_of, mesh):
    """Each leaf's shape, dtype and placements against the reference's
    abstract leaf and the placements of the reference's spec."""
    assert port_abs.keys() == ref_abs.keys() == ref_specs.keys() \
        == port_sh.keys()
    for k, t in port_abs.items():
        ref, p = ref_abs[k], ref_specs[k]
        assert tuple(t.shape) == tuple(ref.shape) == tuple(p.shape), k
        assert _dtype(t.dtype) == _dtype(ref.dtype), k
        want = placements_of(tuple(spec_of(p.axes, p.shape)), mesh)
        assert tuple(port_sh[k]) == want, k


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", jcell.all_cells())
def test_inputs_and_placements_equal_reference(arch, shape, mesh_name):
    sizes = MESHES[mesh_name]
    _world(math.prod(sizes.values()))
    try:
        mesh = lmesh.make_production_mesh(multi_pod="pod" in sizes,
                                          device_type="cpu")
        c = cell.build_cell(arch, shape, mesh)
    finally:
        dist.destroy_process_group()
    jshape = JSHAPES[shape]
    act = (jcell.SP_ACT_RULES if arch in jcell.SP_ARCHS
           and jshape.kind != "decode" else None)
    jr = j_make_rules(DuckMesh(sizes), None, act)
    kv = ("int8" if arch in jcell.KV_INT8_ARCHS and jshape.kind == "decode"
          else "bf16")
    jm = j_build(JARCHS[arch], ssd_impl="jnp", kv_cache_dtype=kv)
    jrun = jcell.default_run_config(JARCHS[arch], jshape)
    pdt = jnp.dtype(jrun.param_dtype)
    assert (c.name, c.kind, c.run.microbatch) == (
        f"{arch}__{shape}", jshape.kind, jrun.microbatch)
    assert c.model.ssd_impl == "chunked" and c.model.attn_impl == "blocked"
    assert c.model.kv_cache_dtype == kv

    pspecs = jm.param_specs()
    _check(_flat(c.args[0]), _flat(c.in_shardings[0]),
           _flat(jpr.abstract(pspecs, pdt)), _flat(pspecs), jr.param_spec,
           mesh)
    B, S = jshape.global_batch, jshape.seq_len
    if jshape.kind == "train":
        ocfg = jopt.OptConfig(name=JARCHS[arch].optimizer,
                              weight_decay=jrun.weight_decay,
                              grad_clip=jrun.grad_clip)
        ospecs = jopt.state_spec_tree(JARCHS[arch].optimizer, pspecs, ocfg)
        odt = jnp.dtype(jrun.optimizer_dtype)
        jo_abs = type(ospecs)(*(jpr.abstract(f, odt) for f in ospecs))
        _check(_fields(c.args[1]), _fields(c.in_shardings[1]),
               _fields(jo_abs), _fields(ospecs), jr.param_spec, mesh)
        assert c.donate_argnums == (0, 1)
    if jshape.kind in ("prefill", "decode"):
        cspecs = jm.cache_specs(B, S)
        c_sh = c.out_shardings[1]
        if jshape.kind == "decode":
            _check(_flat(c.args[1]), _flat(c.in_shardings[1]),
                   _flat(j_cache_abstract(jm, B, S, pdt)), _flat(cspecs),
                   jr.act_spec, mesh)
            assert _flat(c_sh) == _flat(c.in_shardings[1])
            assert c.donate_argnums == (1,)
        else:
            for k, p in _flat(cspecs).items():
                assert tuple(_flat(c_sh)[k]) == placements_of(
                    tuple(jr.act_spec(p.axes, p.shape)), mesh), k

    # the batch: the reference's input specs and batch axes
    jb = jm.input_specs(jshape, pdt)
    jaxes = jm.batch_logical_axes(jshape)
    tb, tb_sh = c.args[-1], c.in_shardings[-1]
    assert tb.keys() == jb.keys() == tb_sh.keys()
    for k, ref in jb.items():
        shape_ = tuple(ref.shape)
        want = placements_of(tuple(jr.act_spec(jaxes.get(k, ()), shape_)),
                             mesh)
        assert tuple(tb_sh[k]) == want, k
        if k == "pos":          # a Python int in the port, 0-d in the ref
            assert tb[k] == S - 1 and shape_ == ()
        elif k == "tokens":     # torch's index dtype where the ref has s32
            assert tuple(tb[k].shape) == shape_
            assert (tb[k].dtype, _dtype(ref.dtype)) == (torch.int64, "int32")
        else:
            assert tuple(tb[k].shape) == shape_
            assert _dtype(tb[k].dtype) == _dtype(ref.dtype)


# ------------------------------------------------------------ captures
def _reduced_cell(arch, shape, mesh):
    """The cell at reduced width: ``reduced_config``'s widths and depth;
    mamba2 at one layer, its chunk raised to 4096 (8 chunks at 32k
    tokens, one at 4k): DTensor gathers the strided shards of the scan's
    batched products piece by piece, and the pieces grow with the chunks'
    count; chatglm3-6b's
    train cell in 2 microbatches of 128, so its gradients accumulate, and
    mamba2's in one."""
    red = reduced_config(ARCHS[arch])
    over = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name != "name"}
    if red.ssm is not None:
        over["ssm"] = dataclasses.replace(red.ssm, chunk=4096)
        over["n_layers"] = 1
    run = None
    if SHAPES[shape].kind == "train":
        run = {"microbatch": 0 if red.ssm is not None else 128}
    return cell.build_cell(arch, shape, mesh, model_overrides=over,
                           run_overrides=run)


@pytest.fixture
def mesh_2x2():
    from torch.distributed.device_mesh import DeviceMesh
    _world(4)
    yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                     mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ("chatglm3-6b", "mamba2-1.3b")
    for s in ("train_4k", "prefill_32k", "decode_32k")])
def test_capture_parse_and_simulate_at_reduced_width(arch, shape,
                                                     mesh_2x2):
    c = _reduced_cell(arch, shape, mesh_2x2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gm = c.capture()
    n_inputs = sum(1 for n in gm.graph.nodes if n.op == "placeholder")
    leaves = sum(len(_flat(a)) if not hasattr(a, "_fields") else
                 len(_fields(a)) for a in c.args)
    # every tensor input is one placeholder (a decode step's pos is an int)
    assert n_inputs == leaves - (1 if c.kind == "decode" else 0)
    prog = parse_graph(gm)
    kinds = {o.opcode for o in prog.ops if o.opclass == "collective"}
    assert "all-gather" in kinds            # the FSDP parameter gathers
    assert all(o.group_size == 2 for o in prog.ops
               if o.opclass == "collective")
    rep = simulate(gm, hw=H100, n_chips=4,
                   model_flops_global=cell.model_flops_for(c.run.model,
                                                           c.shape))
    assert rep.n_chips == 4 and np.isfinite(rep.t_est) and rep.t_est > 0
    assert rep.roofline.collective_s > 0
    assert rep.roofline.comm_bytes_per_device == prog.comm_bytes


# (global shape, dtype, placements before, after) of every redistribution
# the reduced chatglm3-6b's decode step makes on a (2, 2) ("data", "model")
# mesh that moves data, in terms of its widths: d, the heads H and KV heads
# K of width D, the MLP's F, the padded vocabulary V, batch B and cache S.
# "Sk" is Shard(k), "R" Replicate, "P" a partial sum.  The rope tables and
# the cache mask only slice (Replicate -> Shard), which moves nothing.
def _embed(d, H, K, D, F, V, B, S):
    return [((V, d), "bf16", "S1 S0", "S1 R"),      # table: the vocab
            ((B, 1), "s64", "S0 R", "R R"),         # tokens, to index it
            ((B, 1, d), "bf16", "S2 R", "S0 R")]    # lsc(batch, ., embed)


def _layer(d, H, K, D, F, V, B, S):
    return [((d,), "f32", "S0 R", "R R"),           # norm scale
            ((d, K * D), "bf16", "S0 S1", "R S1"),  # wk, FSDP gather
            ((d, K * D), "bf16", "S0 S1", "R S1"),  # wv
            ((d, H * D), "bf16", "S0 S1", "R S1"),  # wq
            ((B, 1, K, D), "bf16", "S0 S3", "S0 R"),  # rope: k's rotary
            ((B, 1, K, D), "bf16", "S0 S3", "S0 R"),  # and plain slices
            ((B, 1, K, D), "bf16", "S0 R", "R R"),   # the cache write:
            ((B, 1, K, D), "bf16", "S0 S3", "R R"),  # k, v gathered whole
            ((B, 1, H, D), "bf16", "S0 S2", "S0 R"),  # lsc(q)
            ((B, 1, H, S), "f32", "S0 S3", "S0 R"),  # softmax over kvseq
            ((B, 1, H, D), "bf16", "S0 P", "S0 S2"),  # lsc(p . v)
            ((B, 1, H * D), "bf16", "S0 S2", "R S2"),  # into wo
            ((B, 1, d), "bf16", "S2 P", "S0 R"),     # lsc(attention out)
            ((d,), "f32", "S0 R", "R R"),           # norm scale
            ((d, F), "bf16", "S0 S1", "R S1"),      # wi_gate
            ((d, F), "bf16", "S0 S1", "R S1"),      # wi_up
            ((F, d), "bf16", "S1 S0", "R S0"),      # wo
            ((B, 1, d), "bf16", "S0 P", "S0 R")]    # lsc(x + mlp)


def _head(d, H, K, D, F, V, B, S):
    return [((d,), "f32", "S0 R", "R R"),           # final norm scale
            ((B, d), "bf16", "S0 R", "S1 R"),       # x into the head
            ((B, 1, V), "bf16", "P S2", "S0 S2"),   # lsc(logits)
            ((B, V), "bf16", "S0 S1", "S0 R")]      # the token's argmax


ITEMSIZE = {"bf16": 2, "f32": 4, "s64": 8}


def _collectives(shape, dtype, before, after, sizes=(2, 2)):
    """The collectives one redistribution issues, mesh dims from the
    innermost out, as DTensor orders them: Shard -> Replicate an
    all-gather of the local shard, Partial -> Replicate an all-reduce,
    Partial -> Shard a reduce-scatter, Shard(a) -> Shard(b) an all-to-all
    of the local shard (as a CUDA mesh issues it; ``Cell.capture`` traces
    it so on the CPU mesh too); Replicate -> Shard only slices."""
    before, after = before.split(), after.split()
    local = list(shape)
    for n, p in zip(sizes, before):
        if p[0] == "S":
            local[int(p[1:])] //= n
    out = []
    for i in reversed(range(len(sizes))):
        a, b, n = before[i], after[i], sizes[i]
        if a == b:
            continue
        nbytes = math.prod(local) * ITEMSIZE[dtype]
        if a[0] == "S":
            out.append(("all-to-all" if b[0] == "S" else "all-gather",
                        nbytes, n))
            local[int(a[1:])] *= n
        elif a == "P":
            out.append(("all-reduce" if b == "R" else "reduce-scatter",
                        nbytes, n))
        if b[0] == "S":
            local[int(b[1:])] //= n
    return out


def test_decode_collectives_equal_a_count_by_hand(mesh_2x2):
    c = _reduced_cell("chatglm3-6b", "decode_32k", mesh_2x2)
    cfg, shape = c.model.cfg, c.shape
    dims = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.padded_vocab, shape.global_batch, shape.seq_len)
    moves = (_embed(*dims) + cfg.n_layers * _layer(*dims) + _head(*dims))
    want = sorted(x for m in moves for x in _collectives(*m))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prog = parse_graph(c.capture())
    got = sorted((o.opcode, o.comm_bytes, o.group_size) for o in prog.ops
                 if o.opclass == "collective")
    assert len(got) == len(want) == 3 + 20 * cfg.n_layers + 4
    assert sum(b for _, b, _ in got) == sum(b for _, b, _ in want)
    assert got == want


def test_the_cell_capture_tool_at_reduced_width():
    """``tools/cell_capture_torch.py`` (chip_smoke's phase 33 at full
    width) on the reduced chatglm3-6b decode cell and a (2, 2) mesh: the
    same collectives as the count by hand, and its report's fields."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "cell_capture_torch.py"
    spec = importlib.util.spec_from_file_location("cell_capture_torch", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    res = tool.capture_cell("chatglm3-6b", "decode_32k", reduced=True,
                            mesh_shape=(2, 2))
    assert not dist.is_initialized()
    cfg = reduced_config(ARCHS["chatglm3-6b"])
    dims = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.padded_vocab, 128, 32768)
    moves = (_embed(*dims) + cfg.n_layers * _layer(*dims) + _head(*dims))
    want = [x for m in moves for x in _collectives(*m)]
    assert res["cell"] == "chatglm3-6b__decode_32k" and res["n_chips"] == 4
    assert sum(c["count"] for c in res["collectives"].values()) == len(want)
    assert res["comm_bytes"] == sum(b for _, b, _ in want)
    assert res["t_est_s"] > 0 and res["peak_rss_bytes"] > 0
    assert len(res["top_ops"]) == tool.TOP_OPS
    assert sum(res["bytes_by_opcode"].values()) == pytest.approx(res["bytes"])
