"""Throughput accounting (copy of ``ThroughputMeter`` from
``ospo_tpu/utils/profiling.py``)."""

from __future__ import annotations

import time


class ThroughputMeter:
    """Rolling throughput over a window of recent update() calls."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events = []  # (timestamp, units)
        self.total_units = 0.0

    def update(self, units: float) -> None:
        self.total_units += units
        self._events.append((time.time(), units))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def rate(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        units = sum(u for _, u in self._events[1:])
        return units / dt if dt > 0 else 0.0
