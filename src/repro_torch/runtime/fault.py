"""Fault-tolerant training runtime: checkpoint / restart, a straggler
watchdog, and failure injection for tests and drills.

The port of `repro.runtime.fault`, over the port's checkpoint module, with
the reference's loop, history fields and restore-from-latest rule:

  * every K steps an async checkpoint of the state (params, opt state);
  * a step watchdog flags stragglers (step > factor x running median);
  * on failure: restore the latest committed checkpoint and continue from
    the step after it (the data stream is step-indexed, so it resumes
    byte for byte), or start over from the initial state without one.

Elastic re-meshing, the reference's contract: a checkpoint restores onto
a NEW mesh, on which the data axis may grow or shrink (the global batch
and the ``"model"`` axis's layout are invariants: another ``"model"`` size
raises). `run_with_recovery` restores onto the placements of the state it
was given, DTensors on that state's mesh (`ckpt.placements_of`), whatever
mesh the checkpoint was written from; a plain state restores onto its
leaves' device.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

from ..checkpoint import ckpt as ckpt_lib


class FailureInjector:
    """Deterministically raise at given steps (tests / chaos drills)."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.failed = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.failed:
            self.failed.add(step)
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class StepWatchdog:
    """Flags steps slower than `factor` x running median as stragglers."""

    factor: float = 3.0
    window: int = 32
    _times: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        times = self._times
        is_straggler = False
        if len(times) >= 5:
            med = sorted(times)[len(times) // 2]
            if seconds > self.factor * med:
                self.stragglers.append((step, seconds, med))
                is_straggler = True
        times.append(seconds)
        if len(times) > self.window:
            times.pop(0)
        return is_straggler


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    max_failures: int = 3


def run_with_recovery(cfg: TrainLoopConfig, *, init_state, step_fn: Callable,
                      make_batch: Callable, injector: Optional[FailureInjector]
                      = None, watchdog: Optional[StepWatchdog] = None):
    """Generic fault-tolerant loop.

    init_state: a tree (params, opt, ...), the checkpointable unit; its
      leaves give each restored leaf's dtype and device, or its mesh and
      placements (DTensor leaves)
    step_fn(state, batch, step) -> (state, metrics)
    make_batch(step) -> batch
    Returns (state, history dict).
    """
    saver = ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir)
    state = init_state
    onto = ckpt_lib.placements_of(init_state)
    start = 0
    restored = ckpt_lib.latest_step(cfg.ckpt_dir)
    if restored is not None:
        state = ckpt_lib.restore(state, restored, cfg.ckpt_dir,
                                 shardings=onto)
        start = restored + 1

    failures = 0
    history = {"steps": [], "recoveries": 0, "stragglers": 0}
    step = start
    while step < cfg.total_steps:
        try:
            t0 = time.monotonic()
            if injector is not None:
                injector.maybe_fail(step)
            batch = make_batch(step)
            state, metrics = step_fn(state, batch, step)
            dt = time.monotonic() - t0
            if watchdog is not None and watchdog.observe(step, dt):
                history["stragglers"] += 1
            history["steps"].append(step)
            if step % cfg.ckpt_every == 0:
                saver.save(state, step)
            step += 1
        except Exception:
            # the loop's boundary: any failure of a step is recovered from
            # the latest checkpoint, up to max_failures times
            failures += 1
            if failures > cfg.max_failures:
                raise
            saver.wait()
            restored = ckpt_lib.latest_step(cfg.ckpt_dir)
            if restored is not None:
                state = ckpt_lib.restore(state, restored, cfg.ckpt_dir,
                                         shardings=onto)
                step = restored + 1
            else:
                state = init_state
                step = 0
            history["recoveries"] += 1
    saver.wait()
    return state, history
