"""The port's own tracing: a span recorder, the hand-written kernels' launch
counts, and the per-process summary line of a step's run.

``span(name, device=False, **attrs)`` marks a piece of work at a layer
boundary::

    with span("scoring.suffix", rows_run=q_b * n, rows_used=sum(q_counts)):
        ...

A span records its name, host start and end (``time.perf_counter_ns``, the
clock of ``time.perf_counter``), its parent (the innermost span open on its
thread when it was made, or the ``parent=`` span handed to another thread),
the id of its unit's root span, its thread and its attrs: counts known at
that boundary.  Spans of one unit share the root's id; work a unit hands to
another thread carries it by passing ``parent=``.

``device=True`` also records a timing-enabled CUDA event pair on the current
stream (when CUDA is initialized).  The events are resolved only when spans
are read (:func:`spans`, :func:`span_totals`), after one synchronize: a span
adds no synchronization, event query or copy to the path it marks.  Device
time enters the totals when read, for the last :data:`CAPACITY` device
spans closed since the read before.  Without
CUDA a device span's device time is its host time.  While a
``torch.profiler`` is recording, a span also enters
``torch.profiler.record_function(name)``, so it stands in the profiler's
trace as a ``user_annotation`` on the kernels' own timeline.

The recorder is always on, as the launch counts are: a bounded ring of the
last :data:`CAPACITY` closed spans (the oldest dropped) and per-name totals
(count, host seconds, device seconds, summed numeric attrs) over the whole
process.  :func:`print_process_summary` prints the totals."""

from __future__ import annotations

import collections
import itertools
import json
import sys
import threading
import time
from typing import Dict, List, Optional

import torch

CAPACITY = 1 << 15

_ids = itertools.count(1)
_clock = time.perf_counter_ns
_thread = threading.get_ident
_profiling = torch.autograd._profiler_enabled


class _Local(threading.local):
    def __init__(self):
        self.stack = []   # this thread's open spans, innermost last


_local = _Local()


class _ThreadTotals(threading.local):
    """One thread's per-name totals, written by that thread alone:
    ``[count, host ns, device s or None, {attr: sum}]``."""

    def __init__(self, registry: list):
        self.by_name: Dict[str, list] = {}
        registry.append(self.by_name)


class SpanRecorder:
    """Closed spans: a ring of the last ``capacity`` and per-name totals.
    Each thread adds to totals of its own, so adding takes no lock; reads
    merge them."""

    def __init__(self, capacity: int = CAPACITY):
        self.ring = collections.deque(maxlen=capacity)
        self._pending = collections.deque(maxlen=capacity)  # device spans unresolved
        self._registry: List[Dict[str, list]] = []
        self._threads = _ThreadTotals(self._registry)
        self._device_s: Dict[str, float] = {}   # resolved device spans' seconds
        self._lock = threading.Lock()           # resolving

    def add(self, s: "span") -> None:
        self.ring.append(s)
        by_name = self._threads.by_name
        t = by_name.get(s.name)
        if t is None:
            t = by_name[s.name] = [0, 0, None, {}]
        t[0] += 1
        t[1] += s.end_ns - s.start_ns
        if s.attrs:
            sums = t[3]
            for k, v in s.attrs.items():
                if isinstance(v, (int, float)):
                    sums[k] = sums.get(k, 0) + v
        if s._events is not None:
            self._pending.append(s)
        elif s.device_s is not None:
            t[2] = (t[2] or 0.0) + s.device_s

    def resolve(self) -> None:
        """Device seconds of every device span closed since the last read
        (one synchronize, then the events' elapsed times)."""
        with self._lock:
            if not self._pending:
                return
            torch.cuda.synchronize()
            while self._pending:
                s = self._pending.popleft()
                s.device_s = s._events[0].elapsed_time(s._events[1]) * 1e-3
                s._events = None
                self._device_s[s.name] = self._device_s.get(s.name, 0.0) + s.device_s

    def spans(self, t0: Optional[float] = None, t1: Optional[float] = None) -> List["span"]:
        """The ring's spans that start at or after ``t0`` and end at or
        before ``t1`` (``time.perf_counter`` seconds), in order of start."""
        self.resolve()
        lo = -1 if t0 is None else int(t0 * 1e9)
        hi = float("inf") if t1 is None else int(t1 * 1e9)
        return sorted((s for s in list(self.ring) if s.start_ns >= lo and s.end_ns <= hi),
                      key=lambda s: s.start_ns)

    def totals(self) -> Dict[str, dict]:
        self.resolve()
        out: Dict[str, dict] = {}
        for by_name in list(self._registry):
            for name, (count, host_ns, device_s, sums) in list(by_name.items()):
                o = out.setdefault(name, {"count": 0, "host_s": 0.0})
                o["count"] += count
                o["host_s"] += host_ns * 1e-9
                if device_s is not None:
                    o["device_s"] = o.get("device_s", 0.0) + device_s
                for k, v in dict(sums).items():
                    o[k] = o.get(k, 0) + v
        with self._lock:
            for name, sec in self._device_s.items():
                o = out.get(name)
                if o is not None:
                    o["device_s"] = o.get("device_s", 0.0) + sec
        return out


RECORDER = SpanRecorder()


class span:
    """A context manager that records one span into :data:`RECORDER` (see
    the module's docstring).  ``parent``: a span of another thread whose
    unit this work belongs to; it need not be open."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "thread", "start_ns",
                 "end_ns", "device_s", "_device", "_events", "_annotation")

    def __init__(self, name: str, device: bool = False, parent: "span" = None, **attrs):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        if parent is None:
            stack = _local.stack
            parent = stack[-1] if stack else None
        if parent is None:
            self.parent, self.root = None, self.id
        else:
            self.parent, self.root = parent.id, parent.root
        self._device = device
        self._events = self._annotation = self.device_s = None

    def __enter__(self) -> "span":
        _local.stack.append(self)
        self.thread = _thread()
        if self._device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        if _profiling():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = _clock()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        if self._events is not None:
            self._events[1].record()
        elif self._device:
            self.device_s = (self.end_ns - self.start_ns) * 1e-9
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:   # closed out of order
            stack.remove(self)
        RECORDER.add(self)

    @property
    def start(self) -> float:
        """Host start, ``time.perf_counter`` seconds."""
        return self.start_ns * 1e-9

    @property
    def end(self) -> float:
        return self.end_ns * 1e-9

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def spans(t0: Optional[float] = None, t1: Optional[float] = None) -> List[span]:
    """The recorded spans inside ``[t0, t1]`` (``time.perf_counter``), with
    device seconds resolved."""
    return RECORDER.spans(t0, t1)


def span_totals() -> Dict[str, dict]:
    """Per span name over the process: count, host seconds, device seconds
    (device spans) and the sums of numeric attrs."""
    return RECORDER.totals()


# each hand-written kernel's launches in this process, counted at its one
# launch site under ops/ (a CUDA graph's replays through add_kernel_launches)
_LAUNCHES = dict.fromkeys((
    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attention",
    "int4_matmul_row", "int4_matmul_group", "moe_route", "moe_align",
    "moe_gate_up", "moe_down", "moe_combine", "w8a16_matmul",
    "suffix_attention", "gdn_decode", "add_rms_norm", "rope_kv_write",
    "silu_mul", "kda_decode"), 0)


def count_launch(name: str) -> None:
    """Count one launch of the kernel ``name`` (its launch site calls this);
    an unknown name raises ``KeyError``."""
    _LAUNCHES[name] += 1


def kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's launch count in this process: a copy of
    the table, so a caller reads what a piece of work launched as the
    difference of two reads."""
    return dict(_LAUNCHES)


def add_kernel_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` to the kernels' counts: a CUDA graph's replay adds
    the launches it replays, and its capture, which launches nothing, takes
    back those it counted.  An unknown name raises ``KeyError`` and changes
    no count."""
    unknown = sorted(set(counts) - _LAUNCHES.keys())
    if unknown:
        raise KeyError(f"no hand-written kernel named {unknown}")
    for name, n in counts.items():
        _LAUNCHES[name] += n


def print_process_summary(stage: str, stats: dict) -> None:
    """One line, ``# <stage> process <rank>/<n>: <JSON>``, of the run's
    statistics, this process's kernel launches and its span totals: how a
    launcher's caller reads each rank of a multi-process run."""
    from ospo_tpu_torch.io import process_count, process_index

    # one write: the ranks share the launcher's output
    sys.stdout.write(f"# {stage} process {process_index()}/{process_count()}: "
                     + json.dumps({**stats, "launches": kernel_launches(),
                                   "spans": span_totals()})
                     + "\n")
    sys.stdout.flush()
