"""Where the serving simulator's decode cells differ between the packages.

The zoo's decode cells (``ZOO_DECODE`` at each batch of
``DECODE_BATCH_GRID``) move far fewer bytes in the port's capture than in
the reference's XLA HLO: 17.6 against 130.9 MB a step for chatglm3-6b at
b64.  ``tools/serving_parity.py``'s ``decode_op_table`` splits each cell
into its matmuls, its cache-slab ops (named for a ``dynamic-slice``,
``dynamic-update-slice`` or ``copy``) and the rest.  These tests pin what
that table shows, for the four serving models at every batch:

* the matmuls are the same work: at b >= 4 equal bytes and FLOPs in both
  packages; at b1 XLA fuses elementwise ops into the dot fusions, so the
  reference's matmul group moves more bytes and at most 1.5 % more FLOPs;
* the reference's surplus is its cache-slab ops: ``lax.scan`` slices each
  layer's slab out of the stacked cache and writes it back, where the
  port's eager step loops over layer views and writes its cache in place
  (``models/attention.py`` ``_write``), which both parsers charge by the
  region written;
* what the two groups leave is a remainder under a stated share of the
  reference's bytes: 4 % for the attention models, where XLA's fusions
  read f32 intermediates the port's ops do not, and 15 % the other way
  for mamba2-1.3b, whose eager SSD decode step runs 260 unfused ops
  against the reference's 27.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

from serving_parity import decode_op_table  # noqa: E402

from repro.core.serving import DECODE_BATCH_GRID  # noqa: E402

MODELS = ("chatglm3-6b", "qwen1.5-32b", "llama4-scout-17b-a16e",
          "mamba2-1.3b")
REMAINDER = {"chatglm3-6b": 0.04, "qwen1.5-32b": 0.04,
             "llama4-scout-17b-a16e": 0.04, "mamba2-1.3b": 0.15}


@pytest.mark.parametrize("batch", DECODE_BATCH_GRID)
@pytest.mark.parametrize("arch", MODELS)
def test_decode_gap_is_the_reference_cache_slab_ops(arch, batch):
    t = decode_op_table(arch, batch)
    r, p = t["reference"], t["port"]
    if batch >= 4:
        assert p["matmul"]["mb"] == pytest.approx(r["matmul"]["mb"], rel=1e-9)
        assert p["matmul"]["mflops"] == pytest.approx(r["matmul"]["mflops"],
                                                      rel=1e-9)
    else:
        assert r["matmul"]["mb"] > p["matmul"]["mb"]
        assert r["matmul"]["mflops"] >= p["matmul"]["mflops"]
        assert r["matmul"]["mflops"] <= 1.015 * p["matmul"]["mflops"]
    assert r["cache"]["mb"] > p["cache"]["mb"]
    assert abs(t["remainder"]) <= REMAINDER[arch]


def test_chatglm3_b64_surplus_is_the_slab_slices_and_updates():
    """The fault candidate's own cell: the dots equal, and the slab ops
    explain 95 % of the 113 MB gap."""
    t = decode_op_table("chatglm3-6b", 64)
    r, p = t["reference"], t["port"]
    assert p["matmul"]["mb"] == pytest.approx(12.12416, rel=1e-6)
    assert r["matmul"]["mb"] == pytest.approx(p["matmul"]["mb"], rel=1e-12)
    assert r["matmul"]["mflops"] == pytest.approx(p["matmul"]["mflops"],
                                                  rel=1e-12)
    gap = sum(r[g]["mb"] - p[g]["mb"] for g in r)
    assert gap == pytest.approx(113.238, rel=1e-4)
    assert r["cache"]["mb"] - p["cache"]["mb"] >= 0.95 * gap
    assert 0 < t["remainder"] <= 0.04
