"""Straggler detection & mitigation (counterpart of
repro/runtime/straggler.py, copied: numpy only).

At thousand-node scale, slow hosts (thermal throttling, failing NICs)
stretch every synchronous step to the slowest participant. The monitor
keeps an EWMA of per-host step times, flags hosts slower than
``threshold`` x the median, and proposes mitigations:

* re-balance: shrink the flagged host's microbatch share (returned as a
  per-host batch-fraction vector the data pipeline consumes);
* evict: after ``evict_after`` consecutive flags, the host should be
  removed and the job restarted from checkpoint at the reduced scale
  (elastic down-scale; Supervisor handles the restart).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class StragglerMonitor:
    n_hosts: int
    alpha: float = 0.3               # EWMA coefficient
    threshold: float = 1.5           # x median = straggler
    evict_after: int = 5             # consecutive flags before eviction
    ewma: Optional[np.ndarray] = None
    flags: Optional[np.ndarray] = None

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)
        self.flags = np.zeros(self.n_hosts, np.int64)

    def observe(self, step_times: np.ndarray) -> Dict[str, object]:
        """step_times: (n_hosts,) seconds for the last step."""
        if self.ewma.sum() == 0:
            self.ewma[:] = step_times
        else:
            self.ewma = (1 - self.alpha) * self.ewma \
                + self.alpha * step_times
        med = float(np.median(self.ewma))
        is_straggler = self.ewma > self.threshold * med
        self.flags = np.where(is_straggler, self.flags + 1, 0)
        evict = np.nonzero(self.flags >= self.evict_after)[0].tolist()

        # microbatch re-balance: give slow hosts proportionally less work
        speed = 1.0 / np.maximum(self.ewma, 1e-9)
        frac = speed / speed.sum()
        return {
            "median_s": med,
            "stragglers": np.nonzero(is_straggler)[0].tolist(),
            "evict": evict,
            "batch_fractions": frac,
        }
