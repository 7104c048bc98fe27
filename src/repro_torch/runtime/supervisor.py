"""Fault-tolerant training supervisor (counterpart of
repro/runtime/supervisor.py, copied with its imports rewritten):
checkpoint/restart with failure injection, elastic down-scale on
eviction, straggler monitoring.

The supervisor owns the outer loop; the inner step is a function of the
state. On any ``TrainingFailure`` (injected in tests; real jobs surface
device/host errors here) it restores the latest checkpoint and resumes —
the data pipeline is step-addressable so resume is exactly-once. This is
the checkpoint/restart contract a thousand-node deployment needs;
scale-out only changes who calls it (one supervisor per job controller).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.ckpt import CheckpointManager
from .straggler import StragglerMonitor


class TrainingFailure(RuntimeError):
    pass


@dataclass
class Supervisor:
    step_fn: Callable[[Any, Dict], Any]      # (state, batch) -> (state, mx)
    batch_fn: Callable[[int], Dict]          # step -> batch
    ckpt: CheckpointManager
    ckpt_every: int = 50
    max_restarts: int = 3
    monitor: Optional[StragglerMonitor] = None
    #: test hook: map step -> exception to inject
    failure_injector: Optional[Callable[[int], Optional[Exception]]] = None
    history: List[Dict] = field(default_factory=list)

    def run(self, state: Any, start_step: int, num_steps: int) -> Any:
        restarts = 0
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                state, step = self._run_span(state, step, end)
            except TrainingFailure as e:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                restored = self.ckpt.restore_latest(like=state)
                if restored is None:
                    raise TrainingFailure(
                        "failure before first checkpoint") from e
                state, step = restored
                self.history.append(
                    {"event": "restart", "at_step": step,
                     "cause": str(e)})
        return state

    def _run_span(self, state, step, end):
        while step < end:
            if self.failure_injector is not None:
                exc = self.failure_injector(step)
                if exc is not None:
                    raise TrainingFailure(str(exc))
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            state, metrics = self.step_fn(state, batch)
            dt = time.perf_counter() - t0
            self.history.append({"event": "step", "step": step,
                                 "seconds": dt,
                                 "metrics": {k: float(v) for k, v in
                                             metrics.items()}})
            if self.monitor is not None:
                # single-host container: synthesize per-host times
                report = self.monitor.observe(
                    np.full(self.monitor.n_hosts, dt))
                if report["evict"]:
                    self.history.append({"event": "evict",
                                         "hosts": report["evict"]})
            step += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, state)
        return state, step
