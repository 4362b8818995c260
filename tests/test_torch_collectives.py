"""``parallel.collectives`` and ``launch.mesh``'s guards against the
reference's, bit for bit.

``CollectiveCost`` (wire bytes, seconds), ``axis_size`` and
``grad_sync_bytes`` over every collective kind, group size and payload the
reference's own tests use (``tests/test_cluster.py``), on duck-typed
meshes in both packages and, for the port, on a torch ``DeviceMesh`` over
torch's fake process group; ``_take_devices``' under- and over-provision
behaviour with the reference's messages.
"""
import math
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch.mesh import _take_devices as j_take_devices
from repro.parallel import collectives as jc
from repro_torch.core.cost import collective_factor, collective_links, cost_op
from repro_torch.core.hlo import OpStat
from repro_torch.core.hwspec import A64FX_CORE
from repro_torch.launch import mesh as lmesh
from repro_torch.parallel import collectives as tc

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "weird-op")
GROUPS = (1, 2, 4, 48)
PAYLOADS = (3.7e6, 0.0, 1.0, 123456789.0)


class DuckMesh:
    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.zeros(shape)


@pytest.mark.parametrize("kind", KINDS)
def test_collective_cost_bit_identical(kind):
    hw = A64FX_CORE
    for g in GROUPS:
        for payload in PAYLOADS:
            for bw, links, st in ((6.8e9, 2, 0.0),
                                  (hw.ici_bw_per_link, 2,
                                   hw.collective_startup_us),
                                  (0.0, 1, 7.0), (1e9, 4, 1.5)):
                a = jc.CollectiveCost(kind, g, payload, bw, links, st)
                b = tc.CollectiveCost(kind, g, payload, bw, links, st)
                assert b.wire_bytes == a.wire_bytes, (g, payload)
                assert b.wire_bytes == collective_factor(kind, g) * payload
                ta, tb = a.t_seconds, b.t_seconds
                assert tb == ta or (math.isinf(ta) and math.isinf(tb))


@pytest.mark.parametrize("kind", KINDS[:-1])
def test_t_seconds_matches_the_ports_cost_op(kind):
    hw = A64FX_CORE
    for g in GROUPS:
        for payload in PAYLOADS:
            o = OpStat(name="c", opcode=kind, opclass="collective",
                       dtype="f32", comm_bytes=payload, group_size=g)
            ot = cost_op(o, hw, ici_bw=2 * hw.ici_bw_per_link)
            cc = tc.CollectiveCost(kind, g, payload,
                                   link_bw=hw.ici_bw_per_link, links=2,
                                   startup_us=hw.collective_startup_us)
            assert cc.t_seconds == ot.t_ici, (g, payload)
    assert collective_links(kind, 2) == (1 if kind == "collective-permute"
                                         else 2)


def _meshes(names, shape):
    """The same mesh for the reference (duck) and the port (duck and a
    DeviceMesh over the fake world)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(shape))
    dm = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                    mesh_dim_names=names)
    return DuckMesh(names, shape), [DuckMesh(names, shape), dm]


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("names,shape", [
    (("data", "model"), (4, 16)), (("data", "model"), (16, 16)),
    (("pod", "data", "model"), (2, 16, 16)), (("data", "model"), (1, 1))])
def test_axis_size_and_grad_sync_bytes(names, shape, fake_world):
    jm, ports = _meshes(names, shape)
    for m in ports:
        for ax in ("pod", "data", "model", "typo"):
            if ax in names:
                assert tc.axis_size(m, ax) == jc.axis_size(jm, ax)
            else:
                with pytest.raises(KeyError, match=f"no axis '{ax}'"):
                    tc.axis_size(m, ax)
                assert tc.axis_size(m, ax, default=1) == 1
            for pb in (1e9, 3.5e6, 0.0):
                if ax in names:
                    for comp in (False, True):
                        assert tc.grad_sync_bytes(pb, m, comp, ax) == \
                            jc.grad_sync_bytes(pb, jm, comp, ax)
                else:
                    with pytest.raises(KeyError):
                        tc.grad_sync_bytes(pb, m, axis=ax)


def test_take_devices_guards_match_the_reference():
    with pytest.raises(RuntimeError,
                       match=r"need 6 devices for mesh \(2, 3\), have 4"):
        lmesh._take_devices(4, 6, (2, 3))
    with pytest.raises(RuntimeError,
                       match=r"need 6 devices for mesh \(2, 3\), have 4"):
        j_take_devices(list(range(4)), 6, (2, 3))
    for take, devs in ((lmesh._take_devices, 8),
                       (j_take_devices, list(range(8)))):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            take(devs, 6, (2, 3))
        assert [str(x.message) for x in w] == [
            "mesh (2, 3) uses 6 of 8 devices; the remaining 2 are idle"]
    assert lmesh._take_devices(6, 6, (2, 3)).tolist() == [[0, 1, 2],
                                                           [3, 4, 5]]


def test_host_mesh_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lmesh.make_host_mesh(1, 1)
    assert not dist.is_initialized()
