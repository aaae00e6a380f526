"""Throughput accounting (copy of ``ThroughputMeter`` from
``ospo_tpu/utils/profiling.py``) and the per-process summary line of a
step's run."""

from __future__ import annotations

import json
import sys
import time
from typing import Dict


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


def kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's launch count in this process since its
    counter was last set to 0."""
    from ospo_tpu_torch.ops import decode_attention as da
    from ospo_tpu_torch.ops import flash_attention as fa
    from ospo_tpu_torch.ops import int4_matmul as i4

    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
            "flash_bwd_dkv": fa.dkv_launches, "decode_attention": da.launches,
            "int4_matmul_row": i4.row_launches,
            "int4_matmul_group": i4.group_launches}


def print_process_summary(stage: str, stats: dict) -> None:
    """One line, ``# <stage> process <rank>/<n>: <JSON>``, of the run's
    statistics and this process's kernel launches: how a launcher's caller
    reads each rank of a multi-process run."""
    from ospo_tpu_torch.io import process_count, process_index

    # one write: the ranks share the launcher's output
    sys.stdout.write(f"# {stage} process {process_index()}/{process_count()}: "
                     + json.dumps({**stats, "launches": kernel_launches()})
                     + "\n")
    sys.stdout.flush()
