"""Cell builder: one (architecture x input-shape x mesh) dry-run unit.

Counterpart of ``repro.launch.cell``.  ``build_cell`` assembles what one
cell needs: the step function (train step, prefill or decode step per the
shape's kind), the abstract inputs (``meta`` tensors: shape and dtype, no
storage; a decode step's ``pos`` a Python int) and their DTensor
placements on the mesh, with the reference's per-arch policies
(microbatch, sequence-parallel attention, int8 KV cache).

Where the reference lowers a cell (``jax.jit(...).lower``), the port
captures it: ``Cell.capture()`` makes each input's local shard as a fake
tensor (nothing is allocated), wraps it as a DTensor of its placements on
the cell's ``DeviceMesh`` inside the traced function, and returns
``core.aten.capture`` of the step, a GraphModule of one rank's ATen ops
with the collectives that DTensor's redistributions issue, without the
nodes that feed no output.  The capture is loop-aware: each microbatch
and layer loop that the reference scans is traced once and counted its
trips (``core.aten.repeat``), as the reference's parse counts a
``while`` body.  The mesh may
span a fake process group (``torch.testing._internal.distributed.fake_pg``)
of the production world (256 or 512 ranks): nothing runs, and collectives
return tensors of the right shape without data.

    cell = build_cell("chatglm3-6b", "decode_32k", make_production_mesh(
        device_type="cpu"))
    rep = simulate(cell.capture(), hw=H100, n_chips=n_chips(cell.rules.mesh),
                   model_flops_global=model_flops_for(cell.run.model,
                                                      cell.shape))
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ..configs import ARCHS, SHAPES, RunConfig, shapes_for
from ..configs.base import ModelConfig, ShapeConfig
from ..core import aten
from ..models import params as pr
from ..models.lm import LM, build_model
from ..parallel.sharding import (MeshRules, contiguous_stride, make_rules,
                                 shard_shape)
from ..serve.engine import make_decode_step, make_prefill_step
from ..serve.kvcache import cache_abstract, cache_shardings
from ..train.trainer import make_train_step

# Per-arch training policy: microbatch size (0 = whole batch in one shot),
# the reference's (sized so a microbatch's activations fit 16 GiB a chip on
# the single-pod mesh).
TRAIN_MICROBATCH = {
    "nemotron-4-340b": 32,
    "qwen1.5-110b": 32,
    "grok-1-314b": 32,
    "llama4-scout-17b-a16e": 64,
    "qwen1.5-32b": 64,
    "mamba2-1.3b": 32,
    "zamba2-1.2b": 32,
}

# Archs whose q/kv-head counts do not divide the 16-way tensor axis run
# attention (and the residual stream) sequence-parallel instead of
# head-parallel: whisper 20 heads, qwen-32b 40, paligemma 8 q / 1 kv,
# llama4-scout 40 q heads.
SP_ARCHS = {"whisper-large-v3", "qwen1.5-32b", "paligemma-3b",
            "llama4-scout-17b-a16e"}

# int8 KV cache for decode: qwen1.5-32b is full MHA (40 KV heads), the only
# arch whose bf16 32k cache exceeds a chip's HBM on the single-pod mesh.
KV_INT8_ARCHS = {"qwen1.5-32b"}
SP_ACT_RULES = {"sp_seq": ("model",), "rseq": ("model",)}


@dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    kind: str                      # train | prefill | decode
    model: LM
    run: RunConfig
    rules: MeshRules
    fn: Callable
    args: Tuple[Any, ...]          # abstract inputs (meta tensors)
    in_shardings: Tuple[Any, ...]  # placement trees, one per argument
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    static_argnums: Tuple[int, ...] = ()

    @property
    def name(self) -> str:
        return f"{self.arch}__{self.shape.name}"

    def _shards(self) -> list:
        """(local shape, dtype, global shape, placements, argument index) of
        each tensor input, in the order of ``_map_state``'s walk."""
        sizes = tuple(self.rules.mesh.shape)
        out = []
        for i, (a, sh) in enumerate(zip(self.args, self.in_shardings)):
            def visit(t, placements, i=i):
                if isinstance(t, torch.Tensor):
                    out.append((shard_shape(t.shape, placements, sizes),
                                t.dtype, tuple(t.shape), tuple(placements),
                                i))
                return t
            _map_state(visit, a, sh)
        return out

    def argument_bytes(self) -> float:
        """The bytes of one rank's shards of the tensor inputs: the
        ``argument_bytes`` that ``core.aten.memory_analysis`` finds in the
        capture's placeholders, without capturing."""
        return float(sum(math.prod(local) * dt.itemsize
                         for local, dt, *_ in self._shards()))

    def capture(self, loops: bool = True) -> torch.fx.GraphModule:
        """The step as one rank's ATen graph on the cell's mesh (module
        docstring); needs the mesh's process group.  Loop-aware by default,
        as the reference's parse counts a scan's body (``core.aten``'s
        I-4); ``loops=False`` unrolls every loop."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor

        mesh = self.rules.mesh
        shards = self._shards()
        n = iter(range(len(shards)))
        slots = [_map_state(lambda t, _: _Slot(next(n))
                            if isinstance(t, torch.Tensor) else t, a, s)
                 for a, s in zip(self.args, self.in_shardings)]
        with FakeTensorMode():
            locals_ = [torch.empty(local, dtype=dt, device=mesh.device_type)
                       for local, dt, *_ in shards]

        def step(locals_):
            def wrap(slot, _):
                if not isinstance(slot, _Slot):
                    return slot
                shape, placements = shards[slot.i][2:4]
                return DTensor.from_local(
                    locals_[slot.i], mesh, placements, run_check=False,
                    shape=torch.Size(shape), stride=contiguous_stride(shape))

            args = [_map_state(wrap, s, s) for s in slots]
            if self.kind == "train":
                out = self.fn(*args)
            else:
                with torch.no_grad():
                    out = self.fn(*args)
            return _to_local(out)

        gm = capture_on_mesh(step, locals_, loops=loops)
        inputs = [n for n in gm.graph.nodes if n.op == "placeholder"]
        for node, shard in zip(inputs, shards):
            node.meta["donated"] = shard[4] in self.donate_argnums
        return gm


def capture_on_mesh(fn: Callable, *args,
                    loops: bool = False) -> torch.fx.GraphModule:
    """``core.aten.capture(fn, *args, loops=loops)`` of a step over
    DTensors, as
    ``Cell.capture`` takes it: DTensor's redistributions traced as a CUDA
    mesh issues them (``_dtensor_as_on_cuda``), and without the nodes that
    feed no output, as XLA drops them (torch 2.11's DTensor propagates
    shapes by running each op on empty tensors of the global shape, which
    the capture records beside the rank's ops; the in-place ones, which
    dead-code elimination keeps, ``core.aten.drop_dead_writes`` drops)."""
    with _dtensor_as_on_cuda():
        gm = aten.capture(fn, *args, loops=loops)
    gm.graph.eliminate_dead_code()
    aten.drop_dead_writes(gm)
    gm.recompile()
    return gm


@contextlib.contextmanager
def _dtensor_as_on_cuda():
    """DTensor's layout arithmetic and collectives as on a CUDA mesh, for a
    capture on a CPU mesh over torch's fake process group (where nothing
    runs):

    * a strided shard's layout (a dim flattened from two dims sharded on
      different mesh dims, as a bmm's batch dims are) builds an index
      tensor and reads it back; inside a capture that tensor is fake, so
      ``_StridedShard.local_shard_size_and_offset`` is computed outside the
      capture, on real integers (torch 2.11 and 2.13 have the method);
    * a Shard(a) -> Shard(b) redistribution is an all-to-all
      (``Shard._to_new_shard_dim`` calls ``shard_dim_alltoall`` of
      ``torch.distributed.tensor._collective_utils``, imported into
      ``placement_types``, in 2.11 and 2.13).  On a CPU mesh that function
      falls back to an all-gather and a chunk, because gloo has no
      all-to-all; here it is ``_all_to_all`` instead, the
      ``_c10d_functional.all_to_all_single`` a CUDA mesh issues through
      ``_dtensor::shard_dim_alltoall``.
    """
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _collective_utils, placement_types
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

    patches = [(m, "shard_dim_alltoall", _all_to_all)
               for m in (_collective_utils, placement_types)]
    cls = getattr(placement_types, "_StridedShard", None)
    layout = getattr(cls, "local_shard_size_and_offset", None)
    if layout is not None:
        def concrete(*args, **kwargs):
            with unset_fake_temporarily(), disable_proxy_modes_tracing():
                return layout(*args, **kwargs)
        patches.append((cls, "local_shard_size_and_offset", concrete))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def _all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
    """``input``, sharded on ``gather_dim`` over ``mesh_dim``, resharded on
    ``shard_dim`` by one ``all_to_all_single``: chunk j of ``shard_dim`` goes
    to rank j, and rank j's piece comes back in its place on
    ``gather_dim`` (DTensor pads ``shard_dim`` to a multiple of the group
    first)."""
    import torch.distributed._functional_collectives as funcol

    n, nd = mesh.size(mesh_dim), input.dim()
    x = input.movedim(shard_dim, 0).contiguous()
    y = funcol.all_to_all_single(x, None, None, (mesh, mesh_dim))
    if isinstance(y, funcol.AsyncCollectiveTensor):
        y = y.wait()
    # y as (n, shard_dim's chunk, the other dims): put the sender's index n
    # before gather_dim and the chunk at shard_dim, in one copy
    y = y.view(n, x.shape[0] // n, *x.shape[1:])
    order = []
    for d in range(nd):
        if d == gather_dim:
            order.append(0)
        order.append(1 if d == shard_dim else 2 + d - (d > shard_dim))
    shape = list(input.shape)
    shape[gather_dim] *= n
    shape[shard_dim] //= n
    return y.permute(order).reshape(shape)


@dataclass(frozen=True)
class _Slot:
    """An input's index among ``Cell.capture``'s local shards."""
    i: int


def _map_state(f, tree, other):
    """``pr.tree_map`` that also walks an optimizer state (a NamedTuple of
    trees) field by field."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_state(f, a, b)
                            for a, b in zip(tree, other)))
    return pr.tree_map(f, tree, other)


def _to_local(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.to_local()
    if isinstance(x, dict):
        return {k: _to_local(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        vals = [_to_local(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


def default_run_config(cfg: ModelConfig, shape: ShapeConfig,
                       **overrides) -> RunConfig:
    mb = TRAIN_MICROBATCH.get(cfg.name, 0) if shape.kind == "train" else 0
    base = RunConfig(model=cfg, shape=shape, microbatch=mb)
    return dataclasses.replace(base, **overrides) if overrides else base


def batch_abstract(model: LM, shape: ShapeConfig,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    return model.input_specs(shape, dtype)


def batch_shardings(model: LM, shape: ShapeConfig, rules: MeshRules,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """Placements of each model input (a decode step's ``pos`` replicated,
    as the reference places its 0-d input)."""
    axes = model.batch_logical_axes(shape)
    specs = model.input_specs(shape, dtype)
    return {k: rules.act_placements(axes.get(k, ()),
                                    tuple(getattr(s, "shape", ())))
            for k, s in specs.items()}


def build_cell(arch: str, shape_name: str, mesh, *,
               run_overrides: Optional[dict] = None,
               rule_overrides: Optional[dict] = None,
               act_rule_overrides: Optional[dict] = None,
               model_overrides: Optional[dict] = None,
               attn_impl: str = "blocked",
               ssd_impl: Optional[str] = None) -> Cell:
    cfg = ARCHS[arch]
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    shape = SHAPES[shape_name]
    if shape not in shapes_for(cfg):
        raise ValueError(f"{shape_name} is skipped for {arch} "
                         "(see DESIGN.md §Arch-applicability)")
    run = default_run_config(cfg, shape, **(run_overrides or {}))
    if act_rule_overrides is None and arch in SP_ARCHS \
            and shape.kind != "decode":
        act_rule_overrides = SP_ACT_RULES
    rules = make_rules(mesh, rule_overrides, act_rule_overrides)
    if ssd_impl is None:
        # the plain path, as the reference's dry-run keeps its jnp one;
        # the kernels' cost is tools/ssd_kernel_cost_torch.py's question
        ssd_impl = "chunked"
    kv_dtype = ("int8" if arch in KV_INT8_ARCHS and shape.kind == "decode"
                else "bf16")
    model = build_model(cfg, attn_impl=attn_impl, ssd_impl=ssd_impl,
                        kv_cache_dtype=kv_dtype)
    pdt = getattr(torch, run.param_dtype)

    param_specs = model.param_specs()
    p_abs = pr.abstract(param_specs, pdt)
    p_sh = pr.shardings(param_specs, rules)
    b_abs = batch_abstract(model, shape, pdt)
    b_sh = batch_shardings(model, shape, rules, pdt)

    if shape.kind == "train":
        step, _, opt_specs, _, o_sh, _ = make_train_step(model, run, rules)
        odt = getattr(torch, run.optimizer_dtype)
        o_abs = type(opt_specs)(*(pr.abstract(f, odt) for f in opt_specs))
        return Cell(arch=arch, shape=shape, kind="train", model=model,
                    run=run, rules=rules, fn=step,
                    args=(p_abs, o_abs, b_abs),
                    in_shardings=(p_sh, o_sh, b_sh),
                    out_shardings=(p_sh, o_sh, None),
                    donate_argnums=(0, 1))

    if shape.kind == "prefill":
        step = make_prefill_step(model, rules)
        c_sh = cache_shardings(model, shape.global_batch, shape.seq_len, rules)
        return Cell(arch=arch, shape=shape, kind="prefill", model=model,
                    run=run, rules=rules, fn=step,
                    args=(p_abs, b_abs),
                    in_shardings=(p_sh, b_sh),
                    out_shardings=(None, c_sh),
                    donate_argnums=())

    # decode: one new token against a seq_len-deep cache
    step = make_decode_step(model, rules)
    c_abs = cache_abstract(model, shape.global_batch, shape.seq_len, pdt)
    c_sh = cache_shardings(model, shape.global_batch, shape.seq_len, rules)
    return Cell(arch=arch, shape=shape, kind="decode", model=model,
                run=run, rules=rules, fn=step,
                args=(p_abs, c_abs, b_abs),
                in_shardings=(p_sh, c_sh, b_sh),
                out_shardings=(None, c_sh),
                donate_argnums=(1,))


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) pair that runs (32 cells; skips documented)."""
    return [(name, s.name) for name, cfg in ARCHS.items()
            for s in shapes_for(cfg)]


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference fwd)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch          # decode: one token per seq


__all__ = ["Cell", "TRAIN_MICROBATCH", "SP_ARCHS", "KV_INT8_ARCHS",
           "SP_ACT_RULES", "default_run_config", "batch_abstract",
           "batch_shardings", "build_cell", "all_cells", "model_flops_for"]
