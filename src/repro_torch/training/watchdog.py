"""Straggler mitigation, after ``repro.training.watchdog`` (a copy: it is
plain Python, but importing it through ``repro`` loads JAX).

At 1000+ nodes, a single slow host stalls every synchronous step. The
watchdog tracks a robust step-time baseline (median + MAD) and flags
steps exceeding ``threshold`` sigmas; the launcher's policy hooks decide
what to do (log, skip-batch, or trigger elastic re-mesh via
checkpoint/restore — the restart path is exercised in tests).
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class Watchdog:
    window: int = 50
    threshold: float = 5.0          # MAD multiples
    min_samples: int = 10
    on_straggle: Optional[Callable[[int, float, float], None]] = None
    _times: list = field(default_factory=list)
    _t0: float = 0.0
    straggles: list = field(default_factory=list)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        dt = time.perf_counter() - self._t0
        flagged = False
        if len(self._times) >= self.min_samples:
            med = statistics.median(self._times)
            mad = statistics.median(
                abs(t - med) for t in self._times) or 1e-9
            if dt > med + self.threshold * mad and dt > 1.5 * med:
                flagged = True
                self.straggles.append((step, dt, med))
                if self.on_straggle:
                    self.on_straggle(step, dt, med)
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return flagged
