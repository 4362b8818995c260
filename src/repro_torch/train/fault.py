"""Fault tolerance: retry-from-checkpoint step loop + straggler watchdog.

``run_with_retries`` wraps the training loop the way a cluster runner must:

* every step runs under a **deadline watchdog** — a step exceeding
  ``deadline_factor`` x the trailing-median step time marks a *straggler
  event*; after ``straggler_patience`` consecutive events the step is
  treated as a failure (on a real pod: the slow host is evicted and the job
  resumes on the survivors — here: the loop restarts from the last
  checkpoint, optionally on a different mesh = elastic restart),
* any exception in the step (device OOM, injected fault, preemption signal)
  triggers **restore-from-latest-checkpoint** and replay; the data pipeline
  is seekable so the token stream resumes exactly at the restored step,
* checkpoints are written every ``ckpt_every`` steps via the atomic
  protocol in ``checkpoint.py``.

The loop is deliberately synchronous-SPMD-shaped: state is (params,
opt_state), the step is a pure donated function, and *restart is the only
recovery mechanism* — the same contract a 1000-node synchronous job has.

``FaultInjector`` provides deterministic failures for tests/examples.

Counterpart of ``repro.train.fault`` over ``train/checkpoint.py``; the
reference's restart-mesh ``shardings`` wait for meshes (ROADMAP queue 1
item 8).
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import checkpoint as ckpt_lib


class InjectedFault(RuntimeError):
    pass


@dataclass
class FaultInjector:
    """Deterministic fault schedule: fail the *execution* of listed steps
    (once each) — models preemptions/node loss in tests."""
    fail_at_steps: Tuple[int, ...] = ()
    straggle_at_steps: Tuple[int, ...] = ()
    straggle_s: float = 0.0
    _fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.straggle_at_steps and ("s", step) not in self._fired:
            self._fired.add(("s", step))
            time.sleep(self.straggle_s)
        if step in self.fail_at_steps and ("f", step) not in self._fired:
            self._fired.add(("f", step))
            raise InjectedFault(f"injected fault at step {step}")


@dataclass
class LoopReport:
    steps_done: int
    restarts: int
    straggler_events: int
    losses: List[float]
    step_times: List[float]
    state: Any = None        # the final state (the reference returns none)


def run_with_retries(
    *,
    step_fn: Callable,                   # (state, batch) -> (state, metrics)
    init_state: Callable[[], Any],       # builds fresh state at step 0
    batch_fn: Callable[[int], Any],      # step -> batch (seekable pipeline)
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    max_restarts: int = 5,
    deadline_factor: float = 10.0,
    straggler_patience: int = 3,
    injector: Optional[FaultInjector] = None,
    state_like: Optional[Any] = None,    # tree for restore structure
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
) -> LoopReport:
    restarts = 0
    straggler_events = 0
    losses: List[float] = []
    times: List[float] = []

    def restore_or_init():
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is None:
            return 0, init_state()
        like = state_like if state_like is not None else init_state()
        step, state, _ = ckpt_lib.restore(ckpt_dir, like, step=last)
        return step, state

    step, state = restore_or_init()
    consecutive_straggles = 0
    while step < n_steps:
        try:
            batch = batch_fn(step)
            t0 = time.perf_counter()
            if injector is not None:
                injector.check(step)
            state, metrics = step_fn(state, batch)
            dt = time.perf_counter() - t0

            # ---- straggler watchdog
            if len(times) >= 3:
                med = statistics.median(times[-20:])
                if dt > deadline_factor * med:
                    straggler_events += 1
                    consecutive_straggles += 1
                    if consecutive_straggles >= straggler_patience:
                        raise InjectedFault(
                            f"straggler limit at step {step}: {dt:.3f}s vs "
                            f"median {med:.3f}s")
                else:
                    consecutive_straggles = 0
            times.append(dt)
            if "loss" in metrics:
                losses.append(float(metrics["loss"]))
            if on_metrics is not None:
                on_metrics(step, metrics)

            step += 1
            if step % ckpt_every == 0 or step == n_steps:
                ckpt_lib.save(ckpt_dir, step, state)
        except Exception:  # noqa: BLE001 — any failure -> restart protocol
            restarts += 1
            if restarts > max_restarts:
                raise
            step, state = restore_or_init()
            consecutive_straggles = 0
    return LoopReport(steps_done=step, restarts=restarts,
                      straggler_events=straggler_events, losses=losses,
                      step_times=times, state=state)
