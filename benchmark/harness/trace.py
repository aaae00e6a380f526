"""The profiled intervals of a traced run, reduced to what the per-layer
metrics and the result's ``breakdown`` read.

``torch.profiler`` runs between two device synchronizations that the driver
places, once with CUDA activity alone and once with the host's ops too
(recording every host op slows a host-bound loop by half, so the busy time
and the kernels' times come from the first).  Once a profiler has run, the
process keeps paying for it on every launch (on the H100 machine 6–8 µs a
launch before, 12 µs after), so the drivers profile one more unit of work
after the measured window has closed.  Each trace is exported as Chrome
JSON under the run's scratch directory when its interval stops, and
reduced after the run:

- ``window_s``: host seconds between the two synchronizations;
- ``busy_s``: the union of the device's kernel, copy and set intervals;
- ``kernel_s``: device seconds by kernel name (sums, not a union);
- ``idle_by_host_op``: every gap between device intervals, charged to the
  innermost host op of the busiest host thread running at the gap's middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    idle_by_host_op: Dict[str, float]

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(s for name, s in self.kernel_s.items()
                   if any(p in name for p in patterns))

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.kernel_s),
                "idle_gaps": top(self.idle_by_host_op)}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: List[dict], window_s: float) -> TraceSummary:
    dev, kernel_us = [], Counter()
    ops: Dict[object, List[Tuple[float, float, str]]] = {}
    for e in events:
        cat, dur = e.get("cat"), e.get("dur")
        if dur is None or e.get("ph") != "X":
            continue
        ts = float(e["ts"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + float(dur)))
            kernel_us[e.get("name", "?")] += float(dur)
        elif cat == "cpu_op":
            ops.setdefault(e.get("tid"), []).append((ts, ts + float(dur), e["name"]))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    main = sorted(ops.get(max(ops, key=lambda t: len(ops[t])), []) if ops else [])
    starts = [o[0] for o in main]
    idle = Counter()
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid, owner = (a + b) / 2, "host outside any op"
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(i - 400, -1), -1):
            s, e, name = main[j]
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, name)
        if best:
            owner = best[1]
        idle[owner] += (b - a) / 1e6
    return TraceSummary(window_s=window_s, busy_s=busy_s,
                        kernel_s={k: v / 1e6 for k, v in kernel_us.items()},
                        idle_by_host_op=dict(idle))


class Tracer:
    """Two profiled intervals a run, each started and stopped once; no-ops
    when tracing is off.  The device interval records CUDA activity alone
    (the host's pace is left as it is) and gives the busy share and the
    kernels' times; the host interval adds the host's ops, for charging idle
    gaps to them.  Traces are reduced after the window (:meth:`reduce`)."""

    def __init__(self, enabled: bool, scratch: str):
        self.enabled = enabled
        self.scratch = scratch
        self._prof = None
        self._kind = None
        self._done: Dict[str, Tuple[str, float]] = {}
        self.summary: Optional[TraceSummary] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self, host_ops: bool = False) -> None:
        kind = "host" if host_ops else "device"
        if not self.enabled or self._prof is not None or kind in self._done:
            return
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if host_ops:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._kind = kind
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._prof is None:
            return
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        path = os.path.join(self.scratch, f"trace-{self._kind}.json")
        self._prof.export_chrome_trace(path)   # before another interval clears it
        self._done[self._kind] = (path, window_s)
        self._prof = None

    def _events(self, kind: str) -> Tuple[List[dict], float]:
        path, window_s = self._done[kind]
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        return events, window_s

    def reduce(self) -> None:
        """The summary of the device interval, with the host interval's
        idle gaps by host op."""
        self.stop()
        if "device" not in self._done:
            return
        self.summary = reduce_events(*self._events("device"))
        self.summary.idle_by_host_op = {}
        if "host" in self._done:
            self.summary.idle_by_host_op = reduce_events(
                *self._events("host")).idle_by_host_op
