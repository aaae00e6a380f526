"""Readings that the limits of ``correct`` of an MLA/MoE step-3 cell are
set from, on the card at the cell's own size, in one process:

    python3 benchmark/tests/calibrate_mla_moe.py \
        --workload janus-deepseek-v2-lite.step3 --seeds 12 --control 12 --first 8100000000

``calibrate.py``'s step-3 readings (set-up, a short window, the check) for
a cell of ``drivers/step3_mla_moe.py``, whose controls are the reference
with int4 routed experts, with int4 weights throughout (the nearest
precision below the configuration's int8) and with the top-k weights
renormalised.  One
JSON line a seed, then the largest program reading and the smallest
control reading, number by number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]

import calibrate  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first", type=int, default=8_000_000_000)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="chiprun_out/calibrate")
    args = ap.parse_args()
    with open(os.path.join(os.path.dirname(calibrate.BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.workload}.jsonl")
    table = {}
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        prog, ctrl = calibrate.run_checked(bench, args.workload, seed, args.seconds,
                                           i < args.control)
        got = {"program": prog, **({"control": ctrl} if ctrl else {})}
        for name, r in got.items():
            table.setdefault(name, []).append(r)
        line = json.dumps({"seed": seed, **got})
        print(line, flush=True)
        with open(path, "a") as f:
            f.write(line + "\n")
    summary = {"workload": args.workload}
    for name, rows in table.items():
        pick = max if name == "program" else min
        summary[name] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps(summary), flush=True)
    with open(path, "a") as f:
        f.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
