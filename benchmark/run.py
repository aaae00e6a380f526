"""The benchmark of ospo_tpu_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the repository root.  The cell names a
configuration (``benchmark/configs/<config>.json``: the model's published
config, HF fields) and a traffic mix (``benchmark/traffic/<traffic>.json``:
parameters, and the name of the driver, ``benchmark/drivers/<driver>.py``,
that runs such traffic through the program).  A per-layer metric is the
reader ``benchmark/metrics/<name>.py``.  Nothing here names a cell, a
configuration or a metric: a new one is new files and new entries.

A run: set-up (imports, weights made on the device from ``--seed``, the
program's model, warm-up of the traffic's shapes), then a closed-loop window
of ``--seconds``, then the reference check of what the window produced.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled interval inside the same window.  The
last line of standard output is one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the
result's last key.  No card, too few cards, or JAX in the process: a
message, no result, a non-zero exit.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


def _process_start() -> float:
    """Wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's build caches stay inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]

FORBIDDEN = ("jax", "jaxlib", "flax", "ospo_tpu")


class NoResult(Exception):
    """The run cannot produce a result; the message says why."""


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise NoResult(f"{path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    if not os.path.exists(path):
        raise NoResult(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return w, conf


def metrics_for(bench: dict, kind: str, workload: str):
    """The cell's end-to-end (``kind`` 'end_to_end') or per-layer metrics."""
    e2e_here = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if m["name"] in e2e_here]
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e_here)]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device=None, bench_dir: str = HERE) -> dict:
    """Set-up, window and check of one cell → the result object.  ``device``
    None: the run's card (CUDA); a test passes ``"cpu"``."""
    import torch

    from harness.cell import Cell, Record
    from harness.trace import Tracer

    w, conf = cell_spec(bench, workload)
    config = load_json(os.path.join(os.path.dirname(bench_dir), conf["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    driver_mod = load_module(os.path.join(bench_dir, "drivers", traffic["driver"] + ".py"),
                             "drivers_" + traffic["driver"])
    cuda = device is None
    dev = torch.device("cuda" if cuda else device)
    scratch = tempfile.mkdtemp(prefix=f"ospo-bench-{workload}-")
    record = Record(tracer=Tracer(trace and cuda, scratch))
    cell = Cell(name=workload, config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, seed=seed,
                seconds=seconds, trace=trace, device=dev, scratch=scratch,
                record=record)
    try:
        driver = driver_mod.Driver(cell)
        driver.setup()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - T_START
        e2e = driver.window(seconds)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        record.tracer.reduce()
        driver.release()
        gc.collect()
        checks = driver.check()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    e2e["setup_s"] = setup_s
    correct = all(c["value"] <= c["limit"] for c in checks)
    metrics = {}
    if not trace:
        for m in metrics_for(bench, "end_to_end", workload):
            if m["name"] not in e2e:
                raise NoResult(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in metrics_for(bench, "per_layer", workload):
            reader = load_module(os.path.join(bench_dir, "metrics", m["name"] + ".py"),
                                 "metric_" + m["name"].replace(".", "_"))
            value = reader.read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(w["chips"]), "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit_w() if cuda else None}
    result = {"correct": correct, "attempted": int(e2e["attempted"]),
              "failed": int(e2e["failed"]), "metrics": metrics,
              "device": device_info}
    summary = record.tracer.summary
    if trace and summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["notes"] = getattr(driver, "notes", [])
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                          for c in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        w, _ = cell_spec(bench, args.workload)
        import torch

        if not torch.cuda.is_available():
            raise NoResult("no CUDA device: this benchmark runs on the card only")
        if torch.cuda.device_count() < int(w["chips"]):
            raise NoResult(f"{args.workload} needs {w['chips']} cards, "
                           f"{torch.cuda.device_count()} present")
        result = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace))
        found = forbidden_modules()
        if found:
            raise NoResult(f"loaded in this process: {', '.join(found)}")
    except (NoResult, ImportError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    for line in result.pop("notes", []):
        print(line, file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
