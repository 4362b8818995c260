"""Collective helpers + byte accounting (per-collective payload math).

Counterpart of ``repro.parallel.collectives``; a mesh is a torch
``DeviceMesh`` or a duck-typed one (``parallel.sharding.mesh_axis_sizes``).

The analytic ring-model here is the napkin-math side of the engine's
collective port: given a mesh and a payload, predict the per-device bytes
and time a collective should cost.  §Perf hypotheses quote these numbers;
the dry-run's parsed HLO then confirms or refutes them.

The byte math itself lives in ``core.cost`` (``collective_factor`` /
``collective_links``) — this module is a thin mesh-aware veneer over the
ONE canonical collective model, so its numbers can never drift from what
the engines charge (the cross-implementation parity test in
``tests/test_torch_collectives.py`` pins the delegation).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from ..core.cost import collective_factor, collective_links
from .sharding import mesh_axis_names, mesh_axis_sizes

_MISSING = object()


@dataclass(frozen=True)
class CollectiveCost:
    kind: str
    group_size: int
    payload_bytes: float         # per-device operand bytes
    link_bw: float               # bytes/s per direction
    links: int = 2               # bidirectional ring
    startup_us: float = 0.0      # per-collective latency (cost_op convention)

    @property
    def wire_bytes(self) -> float:
        """Per-device bytes on the wire: ``collective_factor`` applied to
        the payload (all-reduce 2(g-1)/g, all-gather g-1 over shard
        bytes, reduce-scatter/all-to-all (g-1)/g, permute 1x; g<=1 moves
        nothing)."""
        return collective_factor(self.kind, self.group_size) \
            * self.payload_bytes

    @property
    def t_seconds(self) -> float:
        """Wire time under the effective link bandwidth + startup.

        Matches ``core.cost.cost_op``'s collective branch: a permute is
        one unidirectional send (no 2-link ring credit —
        ``collective_links``), zero moved bytes charge startup only, and
        a real payload over a zero-bandwidth link is cleanly infeasible
        (``inf``)."""
        moved = self.wire_bytes
        bw = collective_links(self.kind, self.links) * self.link_bw
        if moved > 0.0:
            return (moved / bw if bw > 0.0 else float("inf")) \
                + self.startup_us * 1e-6
        return self.startup_us * 1e-6


def axis_size(mesh, name: str, default=_MISSING) -> int:
    """Size of mesh axis ``name``; raises ``KeyError`` for unknown axes.

    The old ``.get(name, 1)`` fallback silently priced typo'd axes as
    group size 1 — i.e. zero collective cost.  Pass ``default=`` to opt
    back into a fallback where absence is genuinely meaningful (e.g. a
    'pod' axis that single-pod meshes simply don't have).
    """
    sizes = mesh_axis_sizes(mesh)
    if name in sizes:
        return sizes[name]
    if default is not _MISSING:
        return default
    raise KeyError(f"mesh has no axis {name!r}; known axes: "
                   f"{mesh_axis_names(mesh)}")


def grad_sync_bytes(param_bytes: float, mesh,
                    compressed: bool = False,
                    axis: str = "pod") -> Dict[str, float]:
    """Cross-``axis`` gradient sync cost: bf16 all-reduce vs int8-EF scheme.

    Returns per-device wire bytes for both schemes (the §Perf comparison).
    ``axis`` names the data-parallel mesh axis the sync rides (the old
    hardcoded ``"pod"`` is now just the default) and must exist on the
    mesh — a typo raises instead of silently reporting zero bytes.
    """
    g = axis_size(mesh, axis)
    if g <= 1:
        return {"all_reduce": 0.0, "compressed": 0.0}
    ar = 2.0 * (g - 1) / g * param_bytes                     # bf16 AR
    rs = (g - 1) / g * param_bytes                           # bf16 RS half
    ag = (g - 1) / g * (param_bytes / 2 + param_bytes / 2 / 128 * 4)
    # ^ int8 payload (half of bf16 bytes) + fp32 scale per 128 block
    return {"all_reduce": ar, "compressed": rs + ag}
