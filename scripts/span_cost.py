"""The host cost of the span recorder (``ospo_tpu_torch/utils/profiling.py``):
microseconds a span, a span with attrs and a device span, against an empty
context manager, each the least of 7 repeats.  On a card (CUDA initialized)
a device span records two CUDA events; without one it takes its host time.

    python3 scripts/span_cost.py        # one JSON line
"""

from __future__ import annotations

import json
import os
import sys
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ospo_tpu_torch.utils.profiling import span  # noqa: E402


class _Empty:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def per_call_us(stmt: str, number: int) -> float:
    scope = {"span": span, "_Empty": _Empty}
    return min(timeit.repeat(stmt, globals=scope, number=number, repeat=7)) / number * 1e6


def main() -> None:
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device="cuda")
    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "empty_cm_us": per_call_us("with _Empty(): pass", 100_000),
           "span_us": per_call_us("with span('x'): pass", 100_000),
           "span_attrs_us": per_call_us("with span('x', rows_run=3, rows_used=2): pass",
                                        100_000),
           "device_span_us": per_call_us("with span('x', device=True): pass", 20_000)}
    if cuda:
        torch.cuda.synchronize()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
