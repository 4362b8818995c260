"""A reduced step of each architecture, captured unrolled and loop-aware
(``core.aten.capture(..., loops=True)``), for the loop-aware capture's
tests.  JAX-free.

The step is ``reduced_config``'s widths at ``layers`` layers (whisper's
encoder too), batch 4 and 32 tokens in f32; a train step runs
``micro`` microbatches.  The unrolled capture traces the step over real
tensors, the loop-aware one over fake copies of the same inputs.
"""
import dataclasses
import warnings

import pytest
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.core import aten
from repro_torch.models.lm import build_model
from repro_torch.train.trainer import make_train_step

B, S = 4, 32
CLASSES = ("matmul", "elementwise", "transcendental")


def reduced(arch: str, layers: int, chunk=None):
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), n_layers=layers)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, n_encoder_layers=layers)
    if chunk is not None and cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               chunk=chunk))
    return cfg


def step(arch: str, what: str, layers: int = 4, micro: int = 2,
         kv_block: int = 1024, chunk=None):
    """(fn, args) of ``arch``'s reduced ``what`` ("train", "prefill" or
    "decode") step on real tensors (the blocked attention's KV blocks of
    ``kv_block``; the SSM's chunk ``chunk`` where given)."""
    cfg = reduced(arch, layers, chunk)
    model = build_model(cfg, kv_block=kv_block)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: (torch.zeros(v.shape, dtype=v.dtype) if k != "pos" else v)
             for k, v in model.input_specs(ShapeConfig("t", S, B, what),
                                           torch.float32).items()}
    if what == "train":
        run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                        param_dtype="float32", compute_dtype="float32",
                        microbatch=B // micro)
        fn, *_, opt_init = make_train_step(model, run)
        return fn, (params, opt_init(params), batch)
    if what == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                return model.prefill_fn(params, batch)
        return prefill, (params, batch)
    cache = model.init_cache(B, S, dtype=torch.float32, device="cpu")

    def decode(params, cache, batch):
        with torch.no_grad():
            return model.decode_fn(params, cache, batch)
    return decode, (params, cache, batch)


def fake(args):
    """Fake copies of the tensors in ``args`` (one ``FakeTensorMode``)."""
    mode = FakeTensorMode()
    return pytree.tree_map(
        lambda t: mode.from_tensor(t) if isinstance(t, torch.Tensor) else t,
        args)


def captures(arch: str, what: str, layers: int = 4, micro: int = 2):
    """(unrolled GraphModule, loop-aware GraphModule) of the step."""
    fn, args = step(arch, what, layers, micro)
    return (aten.capture(fn, *args),
            aten.capture(fn, *fake(args), loops=True))


def loop_nodes(arch: str, what: str, layers: int) -> int:
    """Graph nodes of the loop-aware capture at ``layers`` layers."""
    fn, args = step(arch, what, layers)
    return len(aten.capture(fn, *fake(args), loops=True).graph.nodes)


def assert_equal_programs(unrolled, loops):
    """The loop-aware capture ``loops`` against ``unrolled``: FLOPs by
    class, op instances, bytes, collective bytes, argument and output
    bytes equal; temp bytes within 0.9-1.1."""
    pu, pl = aten.parse_graph(unrolled), aten.parse_graph(loops)
    cu, cl = pu.by_class(), pl.by_class()
    for cls in CLASSES:
        assert cl[cls]["flops"] == cu[cls]["flops"] > 0, cls
    assert {k: v["n"] for k, v in cl.items()} == \
        {k: v["n"] for k, v in cu.items()}
    assert pl.comm_bytes == pu.comm_bytes
    assert pl.bytes_accessed == pytest.approx(pu.bytes_accessed, rel=1e-9)
    mu, ml = aten.memory_analysis(unrolled), aten.memory_analysis(loops)
    assert (ml["argument_bytes"], ml["output_bytes"]) == \
        (mu["argument_bytes"], mu["output_bytes"])
    assert 0.9 <= ml["temp_bytes"] / mu["temp_bytes"] <= 1.1
    return pu, pl


def cell_at_depth(arch: str, shape: str, mesh, layers: int = 4,
                  chunk: int = 4096):
    """``launch.cell.build_cell`` at the reduced widths and ``layers``
    layers (whisper's encoder too), a train cell in 2 microbatches, the
    SSM's chunk raised to ``chunk`` (as ``test_torch_cell.py``'s reduced
    cells: a chunk of 16 makes 256 chunks at 4k tokens)."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import cell
    red = reduced_config(ARCHS[arch])
    over = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name != "name"}
    over["n_layers"] = layers
    if red.family == "audio":
        over["n_encoder_layers"] = layers
    if red.ssm is not None:
        over["ssm"] = dataclasses.replace(red.ssm, chunk=chunk)
    run = ({"microbatch": SHAPES[shape].global_batch // 2}
           if SHAPES[shape].kind == "train" else None)
    return cell.build_cell(arch, shape, mesh, model_overrides=over,
                           run_overrides=run)


def assert_loop_aware_cell_equals_unrolled(c):
    """``Cell.capture()`` (loop-aware) against ``capture(loops=False)``:
    FLOPs by class, op instances, collective bytes by kind, bytes,
    argument and output bytes equal; temp bytes within 0.9-1.1."""
    from repro_torch.launch.dryrun import collectives_by_kind
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loops, unrolled = c.capture(), c.capture(loops=False)
    pu, pl = assert_equal_programs(unrolled, loops)
    assert collectives_by_kind(pl) == collectives_by_kind(pu)
    assert pl.comm_bytes > 0 and len(loops.graph.nodes) < \
        len(unrolled.graph.nodes)
    return pl
