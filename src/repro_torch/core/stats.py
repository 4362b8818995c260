"""Section-scoped statistics — the paper's stats.txt region extension.

A copy of ``repro.core.stats`` (no JAX; the port's tests hold it bit for bit
against the reference).

gem5 dumps whole-run statistics; the RIKEN simulator added *section*
statistics (stats over a program region), implemented via a two-pass script.
Here sections are first-class: a ``Stats`` object holds named counters;
``section(name)`` scopes every update (and wall time) to that region, and
``delta(a, b)`` gives region differences without any two-pass dance.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator


class Stats:
    """Sectioned counter sink for PA-style accounting (DESIGN.md §2)."""

    def __init__(self) -> None:
        self._sections: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self._stack: list[str] = ["__global__"]

    # ------------------------------------------------------------- sections
    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        """Scope updates (and wall time) to ``name`` until exit.

        Wall-time attribution matches :meth:`add`'s counter semantics:
        an enclosing section's ``wall_s`` covers its nested sections
        (its own dt spans them); a section re-entered recursively is
        credited once, at the outermost exit (an inner exit would
        otherwise double-count — its dt is inside the outer one); and
        ``__global__`` accumulates the wall time of top-level sections.
        """
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            if name not in self._stack:
                self._sections[name]["wall_s"] += dt
                self._sections[name]["entries"] += 1
                if all(s == "__global__" for s in self._stack):
                    self._sections["__global__"]["wall_s"] += dt

    def add(self, counter: str, value: float = 1.0) -> None:
        """Adds to EVERY active section (the full nesting stack).

        Enclosing sections see their nested sections' counters — a
        ``steady`` region that wraps per-batch subsections still reports
        the total — and ``__global__`` (always the stack's base) keeps
        accumulating across sections.  A section re-entered recursively
        on the stack is credited once.
        """
        seen = set()
        for name in self._stack:
            if name not in seen:
                seen.add(name)
                self._sections[name][counter] += value

    # -------------------------------------------------------------- queries
    def get(self, counter: str, section: str = "__global__") -> float:
        return self._sections[section].get(counter, 0.0)

    def section_counters(self, section: str) -> Dict[str, float]:
        return dict(self._sections[section])

    def sections(self) -> list[str]:
        return [s for s in self._sections if s != "__global__"]

    def delta(self, a: str, b: str) -> Dict[str, float]:
        """Counter-wise difference between two sections."""
        keys = set(self._sections[a]) | set(self._sections[b])
        return {k: self._sections[a].get(k, 0.0) - self._sections[b].get(k, 0.0)
                for k in sorted(keys)}

    # --------------------------------------------------------------- output
    def report(self) -> str:
        lines = []
        for sec in ["__global__"] + self.sections():
            lines.append(f"[{sec}]")
            for k, v in sorted(self._sections[sec].items()):
                lines.append(f"  {k:<32s} {v:.6g}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({k: dict(v) for k, v in self._sections.items()},
                          indent=1, sort_keys=True)


GLOBAL_STATS = Stats()
