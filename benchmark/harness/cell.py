"""What one run knows: its cell, its seed, its scratch space, and what the
driver records for the per-layer readers."""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional, Tuple

import torch

from harness.trace import Tracer

WORDS = ("a red apple on a wooden table beside two green glass bottles under "
         "soft morning light with long shadows across the tiled floor and a "
         "small dog sleeping near the open window while blue curtains move "
         "in the warm wind of late summer over distant hills").split()


@dataclasses.dataclass
class Record:
    """Host spans (name, start, end) on ``time.perf_counter``, counters, and
    the shapes of the work done, for the per-layer readers."""

    window: Tuple[float, float] = (0.0, 0.0)
    spans: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tracer: Optional[Tracer] = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def span_seconds(self, name: str) -> float:
        """Seconds of the window that spans of ``name`` cover."""
        w0, w1 = self.window
        return sum(max(0.0, min(b, w1) - max(a, w0)) for n, a, b in self.spans if n == name)

    def idle_share(self, stage: str):
        """Share of the device's time left idle as the window runs: the
        traced unit's device-busy seconds (``traced_units`` of them, profiled
        after the window) over the window's host seconds a unit
        (``idle_unit_s``), in %; None without a trace."""
        s = self.tracer.summary if self.tracer else None
        w = self.work
        if s is None or w.get("stage") != stage or not w.get("idle_unit_s"):
            return None
        return 100.0 * (1.0 - s.busy_s / w["traced_units"] / w["idle_unit_s"])


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    scratch: str
    record: Record = dataclasses.field(default_factory=Record)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def rng(self, salt: str) -> random.Random:
        """A generator of its own for each use, all from ``--seed``."""
        return random.Random(f"{self.seed}/{self.name}/{salt}")


def prompt_text(rng: random.Random, n_chars: int) -> str:
    """Words drawn from ``rng``, cut to exactly ``n_chars`` characters with
    no space at either end: the byte-level stand-in for a prompt of
    ``n_chars`` BPE tokens."""
    words: List[str] = []
    while len(" ".join(words)) < n_chars + 1:
        words.append(rng.choice(WORDS))
    text = " ".join(words)[:n_chars]
    return text[:-1] + "s" if text.endswith(" ") else text
