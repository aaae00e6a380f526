"""One run of a cell on the card, then the program's spans
(``ospo_tpu_torch.utils.profiling``) of every unit the process recorded,
set-up and traced units included:

    python3 benchmark/tests/span_units.py --workload <cell> --seed <n> --seconds 30 [--trace 1]

Prints the run's result line, then one JSON line a unit (a root span and
every span that shares its id): its name, start and end in seconds from the
window's start, its attrs, and per span name the count, host seconds and
device seconds.  Where a unit's time goes: a step-3 group by part, a
step-5 update by phase (update 1 of a fresh process among them), a step-4b
chunk by part.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import run  # noqa: E402


def units(spans, t0: float):
    """Spans grouped by their unit's root → one dict a unit, in order."""
    by_root = {}
    for s in spans:
        by_root.setdefault(s.root, []).append(s)
    out = []
    for members in by_root.values():
        root = next((s for s in members if s.id == s.root), None)
        if root is None:        # its root left the ring
            continue
        parts = {}
        for s in members:
            if s is root:
                continue
            p = parts.setdefault(s.name, {"count": 0, "host_s": 0.0})
            p["count"] += 1
            p["host_s"] += s.host_s
            if s.device_s is not None:
                p["device_s"] = p.get("device_s", 0.0) + s.device_s
        out.append({"unit": root.name, "start": root.start - t0, "end": root.end - t0,
                    "host_s": root.host_s, "device_s": root.device_s,
                    "attrs": root.attrs, "parts": parts})
    return sorted(out, key=lambda u: u["start"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from harness import cell as cell_mod
    from ospo_tpu_torch.utils import profiling

    windows = []
    record_cls = cell_mod.Record

    def record(*args, **kwargs):    # keeps the run's record for its window
        windows.append(record_cls(*args, **kwargs))
        return windows[-1]

    cell_mod.Record = record
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    result = run.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    result.pop("notes", None)
    print(json.dumps(result), flush=True)
    w0, w1 = windows[0].window
    print(json.dumps({"window": [0.0, w1 - w0]}))
    for u in units(profiling.spans(), w0):
        print(json.dumps(u))
    return 0


if __name__ == "__main__":
    sys.exit(main())
