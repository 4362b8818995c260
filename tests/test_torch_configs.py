"""The port's configs equal the reference's, field by field (exact)."""
import dataclasses

import pytest

from repro import configs as jcfg
from repro_torch import configs as tcfg


def test_registry_and_shape_names_equal():
    assert list(tcfg.ARCHS) == list(jcfg.ARCHS)
    assert list(tcfg.SHAPES) == list(jcfg.SHAPES)
    assert list(tcfg.ZOO_SHAPES) == list(jcfg.ZOO_SHAPES)
    assert tcfg.ZOO_PHASES == jcfg.ZOO_PHASES


@pytest.mark.parametrize("name", sorted(jcfg.ARCHS))
def test_arch_and_reduced_config_equal(name):
    ref, port = jcfg.ARCHS[name], tcfg.ARCHS[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tcfg.reduced_config(port)) \
        == dataclasses.asdict(jcfg.reduced_config(ref))
    for cfg_p, cfg_r in ((port, ref),
                         (tcfg.reduced_config(port), jcfg.reduced_config(ref))):
        assert (cfg_p.head_dim, cfg_p.padded_vocab, cfg_p.param_count(),
                cfg_p.active_param_count()) \
            == (cfg_r.head_dim, cfg_r.padded_vocab, cfg_r.param_count(),
                cfg_r.active_param_count())
    assert [s.name for s in tcfg.shapes_for(port)] \
        == [s.name for s in jcfg.shapes_for(ref)]


@pytest.mark.parametrize("name", sorted(jcfg.SHAPES) + sorted(
    s.name for s in jcfg.ZOO_SHAPES.values()))
def test_shape_equal(name):
    every = {**jcfg.SHAPES, **{s.name: s for s in jcfg.ZOO_SHAPES.values()}}
    port = {**tcfg.SHAPES, **{s.name: s for s in tcfg.ZOO_SHAPES.values()}}
    assert dataclasses.asdict(port[name]) == dataclasses.asdict(every[name])
