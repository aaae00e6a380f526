"""Readings that the limits of ``correct`` are set from, on the card at the
cell's own size, in one process:

    python3 benchmark/tests/calibrate.py --workload <cell> --seeds 12 --control 3 --first 5000000000

For each seed: the cell's set-up and a short window (``--seconds``, one
step-3 group or a step-5 update past the checked ones) and the check,
printing the numbers compared.  Steps 3 and 4b: on the first
``--control`` seeds also the control, the reference in int4 (weights and
cache) read at the same positions (and for step 3 a TF32 VQ decode).  Step 5 (``--variants``): the
program with its own lower-precision trunks (``quantize_base`` int8 or
w8a8) and with each planted fault (``faults.py``), from the same weights,
records and adapters, each held to the same reference.  One JSON line a
seed, then the largest program reading and the smallest reading of every
control and fault, number by number.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import torch  # noqa: E402

import faults  # noqa: E402
import run  # noqa: E402
from harness.cell import Cell, Record  # noqa: E402
from harness.trace import Tracer  # noqa: E402


def make_driver(bench, workload, seed, seconds, traffic_over=None):
    w, conf = run.cell_spec(bench, workload)
    config = run.load_json(os.path.join(os.path.dirname(BENCH), conf["file"]))
    traffic = run.load_json(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    if traffic_over:
        traffic = traffic_over(copy.deepcopy(traffic))
    mod = run.load_module(os.path.join(BENCH, "drivers", traffic["driver"] + ".py"),
                          "drivers_" + traffic["driver"])
    scratch = tempfile.mkdtemp(prefix="calibrate-")
    cell = Cell(name=workload, config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, seed=seed, seconds=seconds,
                trace=False, device=torch.device("cuda"), scratch=scratch,
                record=Record(tracer=Tracer(False, scratch)))
    return mod.Driver(cell)


def readings(checks):
    return {c["name"]: c["value"] for c in checks}


def run_checked(bench, workload, seed, seconds, control):
    """Step 3 or 4b: the program's readings and, with ``control``, the
    control's."""
    d = make_driver(bench, workload, seed, seconds)
    d.setup()
    d.window(seconds)
    d.release()
    got = readings(d.check(control=control))
    prog = {k: v for k, v in got.items() if not k.startswith("control_")}
    ctrl = {k[len("control_"):]: v for k, v in got.items() if k.startswith("control_")}
    return prog, ctrl


def _quantize_base(mode):
    def over(t):
        t["trainer"]["experiment"]["quantize_base"] = mode
        return t
    return over


# the control (the program's own lower-precision trunks) and the faults a
# training cell can have, each held to the same reference
STEP5_VARIANTS = {"control_int8": (_quantize_base("int8"), None),
                  "control_w8a8": (_quantize_base("w8a8"), None),
                  "fault_state_unchanged": (None, "state_unchanged"),
                  "fault_half_batch": (None, "half_batch")}


def run_step5(bench, workload, seed, seconds, variants, program=True):
    out = None
    got, extra = {}, {}
    names = (["program"] if program else []) + list(variants)
    for name in names:
        over, fault = STEP5_VARIANTS.get(name, (None, None))
        d = make_driver(bench, workload, seed, seconds, over)
        with faults.planted(fault, "step5") if fault else contextlib.nullcontext():
            d.setup()
            d.window(seconds)
        d.release()
        if out is None:
            out = d.reference()
        got[name] = readings(d.compare(out))
        extra[name] = d.readings
    return got, extra


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3,
                    help="seeds that also read the control (step 3)")
    ap.add_argument("--variants", default="",
                    help="step 5: comma-separated controls and faults read on every seed")
    ap.add_argument("--no-program", action="store_true",
                    help="step 5: read only the variants")
    ap.add_argument("--first", type=int, default=5_000_000_000)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="chiprun_out/calibrate")
    args = ap.parse_args()
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    w, _ = run.cell_spec(bench, args.workload)
    with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
        driver = json.load(f)["driver"]
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.workload}.jsonl")
    variants = [v for v in args.variants.split(",") if v]
    table = {}
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        if driver in ("step3", "step4b"):
            prog, ctrl = run_checked(bench, args.workload, seed, args.seconds, i < args.control)
            got, extra = {"program": prog}, {}
            if ctrl:
                got["control"] = ctrl
        else:
            got, extra = run_step5(bench, args.workload, seed, args.seconds, variants,
                                   not args.no_program)
        for name, r in got.items():
            table.setdefault(name, []).append(r)
        line = json.dumps({"seed": seed, **got, "readings": extra})
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
