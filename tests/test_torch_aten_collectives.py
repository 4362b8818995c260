"""Collectives in the ATen capture (``core.aten``) against the reference's
parser on the HLO that JAX compiles for the same program.

The reference side: a ``jax.shard_map`` over a (2, 4) ("data", "model")
mesh of 8 forced host devices, holding a tiled ``all_gather`` on 'model'
(axis 1), a ``psum_scatter`` on 'model' (axis 1), a ``psum`` on 'data' and
a tiled ``all_to_all`` on 'model', on a (64, 256) f32 input placed
P("data", "model"), and a resharding from P("model", None) to P(None,
"model") (an ``all_to_all`` of split axis 1, concat axis 0); compiled in a
subprocess (the device count is fixed at
JAX's start) and parsed by ``repro.core.hlo.parse_program``.  f32 on both
sides: XLA on the CPU widens bf16 collectives to f32.  The port side: the
same collectives through ``torch.distributed._functional_collectives`` on a
(2, 4) ``DeviceMesh`` over torch's fake process group of 8 ranks, captured
by ``core.aten.capture`` and parsed by ``core.aten.parse_graph``.  Both
give the same (opcode, comm_bytes, group_size) list and the same
collective time per kind under ``cost.cost_program`` on ``TPU_V5E``.  The
resharding's port side is a DTensor Shard(0) -> Shard(1) redistribution
captured as ``launch.cell.Cell.capture`` captures it
(``cell.capture_on_mesh``): one all-to-all of the local shard, as a CUDA
mesh issues it, and no all-gather (a CPU mesh's own fallback).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch.core import aten
from repro_torch.core import cost as tcost
from repro_torch.core.hlo import COLLECTIVES
from repro_torch.core.hwspec import TPU_V5E

SRC = Path(__file__).resolve().parents[1] / "src"

REFERENCE = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import cost
from repro.core.hlo import parse_program
from repro.core.hwspec import TPU_V5E

mesh = jax.make_mesh((2, 4), ("data", "model"))

def body(x):
    g = jax.lax.all_gather(x, "model", axis=1, tiled=True)
    s = jax.lax.psum_scatter(g, "model", scatter_dimension=1, tiled=True)
    r = jax.lax.psum(s, "data")
    return jax.lax.all_to_all(r, "model", 0, 0, tiled=True)

def rows_of(f, x):
    prog = parse_program(jax.jit(f).lower(x).compile().as_text())
    times = cost.cost_program(prog, TPU_V5E)
    return [(o.opcode, o.comm_bytes, o.group_size, t.t_ici)
            for o, t in zip(prog.ops, times) if o.opclass == "collective"]

f = jax.shard_map(body, mesh=mesh, in_specs=P("data", "model"),
                  out_specs=P("data", "model"))
x = jax.ShapeDtypeStruct((64, 256), jnp.float32)
rows = rows_of(f, x)

# a Shard(0) -> Shard(1) resharding on 'model': one all-to-all
reshard = jax.shard_map(
    lambda x: jax.lax.all_to_all(x, "model", 1, 0, tiled=True), mesh=mesh,
    in_specs=P("model", None), out_specs=P(None, "model"))
print(json.dumps({"rows": rows, "reshard": rows_of(reshard, x)}))
"""


@pytest.fixture(scope="module")
def reference_parse():
    proc = subprocess.run([sys.executable, "-c", REFERENCE],
                          capture_output=True, text=True, timeout=240,
                          env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    return {k: [tuple(r) for r in v] for k, v in out.items()}


@pytest.fixture(scope="module")
def reference_rows(reference_parse):
    return reference_parse["rows"]


@pytest.fixture
def mesh():
    """A (2, 4) ("data", "model") mesh over torch's fake process group."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                     mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def _program(mesh, local=(32, 64)):
    """The reference's body on one rank's (32, 64) shard, captured."""
    def body(x):
        g = funcol.all_gather_tensor(x, 1, mesh["model"])
        s = funcol.reduce_scatter_tensor(g, "sum", 1, mesh["model"])
        r = funcol.all_reduce(s, "sum", mesh["data"])
        return funcol.all_to_all_single(r, None, None, mesh["model"])

    gm = aten.capture(body, torch.randn(local))
    return gm, aten.parse_graph(gm)


def _rows(prog):
    times = tcost.cost_program(prog, TPU_V5E)
    return [(o.opcode, o.comm_bytes, o.group_size, t.t_ici)
            for o, t in zip(prog.ops, times) if o.opclass == "collective"]


def test_collectives_equal_the_reference_parse(mesh, reference_rows):
    _, prog = _program(mesh)
    rows = _rows(prog)
    assert [r[:3] for r in reference_rows] == [
        ("all-gather", 8192, 4), ("reduce-scatter", 32768, 4),
        ("all-reduce", 8192, 2), ("all-to-all", 8192, 4)]
    assert [r[:3] for r in rows] == [r[:3] for r in reference_rows]
    # the collective time per kind under the same cost model and spec
    per_kind = {}
    for kind, *_, t in rows:
        per_kind[kind] = per_kind.get(kind, 0.0) + t
    ref_kind = {}
    for kind, *_, t in reference_rows:
        ref_kind[kind] = ref_kind.get(kind, 0.0) + t
    assert per_kind == ref_kind
    assert prog.comm_by_collective() == {
        "all-gather": 8192.0, "reduce-scatter": 32768.0,
        "all-reduce": 8192.0, "all-to-all": 8192.0}


def test_wait_is_free_and_readers_depend_on_the_collective(mesh):
    gm, prog = _program(mesh)
    waits = [n for n in gm.graph.nodes if n.op == "call_function"
             and "wait_tensor" in str(n.target)]
    assert len(waits) == 4
    names = [o.name for o in prog.ops]
    assert not any("wait" in n for n in names)
    kinds = [o.opcode for o in prog.ops]
    ag, rs = kinds.index("all-gather"), kinds.index("reduce-scatter")
    # the gather on dim 1 is a gather on dim 0, a split (a view) and a cat
    cat = kinds.index("concatenate")
    assert ag < cat < rs and prog.ops[cat].deps == [ag]
    assert prog.ops[cat].opclass == "data"
    gathered = 32 * 256 * 4
    assert prog.ops[cat].read_bytes == prog.ops[cat].write_bytes == gathered
    # later collectives read their operand through the waits
    ar = kinds.index("all-reduce")
    assert prog.ops[ar].deps == [rs]
    assert all(o.flops == 0.0 for o in prog.ops if o.opclass == "collective")


def test_broadcast_is_charged_as_an_all_gather(mesh):
    def body(x):
        return funcol.broadcast(x, 0, mesh["model"])

    prog = aten.parse_graph(aten.capture(body, torch.randn(16, 8)))
    (op,) = [o for o in prog.ops if o.opclass == "collective"]
    assert COLLECTIVES["collective-broadcast"] == op.opcode == "all-gather"
    assert (op.comm_bytes, op.group_size, op.dtype) == (16 * 8 * 4, 4, "f32")


def test_bytes_are_the_operand_at_its_dtype(mesh):
    def body(x):
        return funcol.all_gather_tensor(x, 0, mesh["data"])

    prog = aten.parse_graph(aten.capture(
        body, torch.zeros(32, 64, dtype=torch.bfloat16)))
    (op,) = [o for o in prog.ops if o.opclass == "collective"]
    assert (op.opcode, op.dtype, op.comm_bytes, op.group_size) == (
        "all-gather", "bf16", 32 * 64 * 2, 2)
    assert (op.read_bytes, op.write_bytes) == (32 * 64 * 2, 64 * 64 * 2)


def test_an_unknown_collective_raises_and_names_itself(mesh):
    group = funcol._resolve_group_name(mesh["model"])

    def body(x):
        return torch.ops._c10d_functional.all_reduce_(x, "sum", group)

    gm = aten.capture(body, torch.randn(8))
    with pytest.raises(NotImplementedError, match="all_reduce_"):
        aten.parse_graph(gm)


def test_a_collective_without_its_group_size_raises(mesh):
    gm, _ = _program(mesh)
    for n in gm.graph.nodes:
        n.meta.pop("group_size", None)
    with pytest.raises(NotImplementedError, match="no group size"):
        aten.parse_graph(gm)


def _reshard(mesh, capture):
    """A (64, 256) f32 tensor sharded on 'model' along dim 0, resharded
    along dim 1: the parsed collectives."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def body(x):
        d = DTensor.from_local(x, mesh, [Replicate(), Shard(0)],
                               run_check=False)
        return d.redistribute(mesh, [Replicate(), Shard(1)]).to_local()

    gm = capture(body, torch.randn(16, 256))
    return [(o.opcode, o.comm_bytes, o.group_size)
            for o in aten.parse_graph(gm).ops if o.opclass == "collective"]


def test_a_reshard_is_one_all_to_all_as_the_reference_parses_it(
        mesh, reference_parse):
    from repro_torch.launch.cell import capture_on_mesh
    got = _reshard(mesh, capture_on_mesh)
    assert got == [("all-to-all", 16 * 256 * 4, 4)]
    assert [r[:3] for r in reference_parse["reshard"]] == got


def test_the_cpu_mesh_alone_would_gather(mesh):
    """Without ``capture_on_mesh``, the CPU mesh's fallback: an all-gather
    of the local shard (what the capture used to charge)."""
    got = _reshard(mesh, aten.capture)
    assert [k for k, *_ in got] == ["all-gather"]
