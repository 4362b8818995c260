"""The zoo's cluster drivers against the reference's.

* ``mesh_rules_resolver``: the shard decisions of grok-1-314b and
  nemotron-4-340b at tp 1-16, bit for bit (both go through their
  package's ``MeshRules`` on the same duck-typed mesh).
* ``cluster_workload``: the scalars the cluster engine sizes collectives
  with (``frac_attn``, ``layers``, ``d_model``, ``param_bytes``, and the
  rest) equal.
* ``run_cluster`` on the reduced train traces at 2-1024 nodes: the winning
  plan per node count and the model rank equal the reference's, but for
  the differences recorded here.  The two traces differ (the port's eager
  ATen capture against XLA's fused HLO: 1185 against 421 ops for
  grok-1-314b), so close plans may swap: grok-1-314b at 32 nodes wins with
  tp4 x pp8 in the port and tp2 x pp16 in the reference, and at 128 nodes
  the port ranks grok-1-314b ahead of nemotron-4-340b.
* ``tools/cluster_scaling_torch.py --quick`` (the synthetic DAG, which both
  packages schedule on NumPy) equals the reference's ``--quick`` sweep
  number for number, and ``tools/cluster_quick_reference.json`` is that
  sweep, as the card's run of the tool checks it.
"""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import cluster_scaling_torch as cli  # noqa: E402
from benchmarks import cluster_scaling as ref_cli  # noqa: E402
from repro.core import zoo as ref_zoo  # noqa: E402
from repro_torch.core import zoo  # noqa: E402

MODELS = ("grok-1-314b", "nemotron-4-340b")
NODE_COUNTS = (2, 8, 32, 128, 1024)
# (model, nodes) -> (port's winning plan, reference's)
BEST_PLAN_DIFFS = {("grok-1-314b", "32"): ("dp1xtp4xpp8", "dp1xtp2xpp16")}
RANK_DIFFS = {"128": (["grok-1-314b", "nemotron-4-340b"],
                      ["nemotron-4-340b", "grok-1-314b"])}


@pytest.mark.parametrize("arch", MODELS)
def test_mesh_rules_resolver_decisions_bit_for_bit(arch):
    ref, port = ref_zoo.mesh_rules_resolver(arch), zoo.mesh_rules_resolver(arch)
    for tp in range(1, 17):
        assert dataclasses.asdict(port(tp)) == dataclasses.asdict(ref(tp)), tp


@pytest.mark.parametrize("arch", MODELS)
def test_cluster_workload_scalars_equal(arch):
    a, b = ref_zoo.cluster_workload(arch), zoo.cluster_workload(arch)
    for k in ("frac_attn", "layers", "d_model", "param_bytes", "repeats",
              "seq_len", "batch", "moe_top_k", "name"):
        assert getattr(b, k) == getattr(a, k), k


@pytest.fixture(scope="module")
def sweeps():
    return tuple(z.run_cluster(node_counts=NODE_COUNTS).to_dict()
                 for z in (zoo, ref_zoo))


@pytest.mark.parametrize("arch", MODELS)
def test_run_cluster_winning_plans_match_but_the_recorded(sweeps, arch):
    got, want = sweeps
    g, w = got["models"][arch], want["models"][arch]
    assert set(g["plans"]) == set(w["plans"])
    for n in g["plans"]:
        assert set(g["plans"][n]) == set(w["plans"][n]), n
        diff = BEST_PLAN_DIFFS.get((arch, n))
        if diff is None:
            assert g["best_plan"][n] == w["best_plan"][n], n
        else:
            assert (g["best_plan"][n], w["best_plan"][n]) == diff, n


def test_run_cluster_rank_matches_but_the_recorded(sweeps):
    got, want = sweeps
    for n in got["rank"]:
        diff = RANK_DIFFS.get(n)
        if diff is None:
            assert got["rank"][n] == want["rank"][n], n
        else:
            assert (got["rank"][n], want["rank"][n]) == diff, n


def _numbers(report):
    d = report.to_dict()
    d.pop("wall_s")
    return d


def test_quick_sweep_equals_the_reference_and_its_committed_copy():
    got, want = _numbers(cli.quick_report()), _numbers(ref_cli.quick_report())
    assert got == want
    committed = json.loads(cli.QUICK_REFERENCE.read_text())
    committed.pop("mode")
    assert committed == want
    assert cli.check_sanity(cli.quick_report(), 0.5) == []
