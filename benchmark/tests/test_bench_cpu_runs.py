"""Whole runs of each driver on the CPU at the tiny configuration, with the
program's plain paths: the result's keys, the reference against the program,
the lower-precision controls and planted faults failing the comparison, and
a cell, a traffic mix and a per-layer metric added as files alone."""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, BENCH, os.path.dirname(BENCH)]

import faults  # noqa: E402
import run  # noqa: E402
import tiny  # noqa: E402

SEED = 4_294_967_311   # more than 32 bits hold


def _run(tmp_path, name, traffic, trace=False, extra=None):
    bench_dir = tiny.make_tree(str(tmp_path), {name: (name.replace(".", "-"), traffic)})
    if extra:
        extra(bench_dir)
    with open(os.path.join(str(tmp_path), "BENCHMARK.json")) as f:
        bench = json.load(f)
    torch.manual_seed(0)
    return run.run_cell(bench, name, SEED, 1.0, trace, device="cpu", bench_dir=bench_dir)


def _keys_ok(res):
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "compared"
    assert res["attempted"] > 0 and res["failed"] == 0
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"}


def test_step3_runs_and_matches_the_reference(tmp_path):
    res = _run(tmp_path, "tiny.step3", tiny.step3_traffic())
    _keys_ok(res)
    assert set(res["metrics"]) == {"img_tok_per_s", "setup_s"}
    assert res["correct"], res["compared"]


def test_step5_runs_and_matches_the_reference(tmp_path):
    res = _run(tmp_path, "tiny.step5", tiny.step5_traffic())
    _keys_ok(res)
    assert set(res["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert res["correct"], res["compared"]


def test_step4b_runs_and_matches_the_reference(tmp_path):
    res = _run(tmp_path, "tiny.step4b", tiny.step4b_traffic())
    _keys_ok(res)
    assert set(res["metrics"]) == {"scored_images_per_s", "setup_s"}
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("stage", ["step3", "step4b"])
def test_control_int4_fails(tmp_path, stage):
    """The reference in int4 (weights and cache) read against the int8
    reference at the same positions."""
    traffic = {"step3": tiny.step3_traffic, "step4b": tiny.step4b_traffic}[stage]()
    name = f"tiny.{stage}"
    bench_dir = tiny.make_tree(str(tmp_path), {name: (name.replace(".", "-"), traffic)})
    bench = json.load(open(os.path.join(str(tmp_path), "BENCHMARK.json")))
    driver = _driver(bench_dir, bench, name)
    driver.setup()
    driver.window(1.0)
    driver.release()
    checks = {c["name"]: c for c in driver.check(control=True)}
    key = "logit_gap" if stage == "step3" else "readout_gap"
    assert checks[key]["value"] <= checks[key]["limit"]
    assert checks["control_" + key]["value"] > checks[key]["limit"]


def test_step5_control_int8_trunk_fails(tmp_path):
    """The program's own lower-precision path: the int8 frozen trunk."""
    t = tiny.step5_traffic()
    t["trainer"]["experiment"]["quantize_base"] = "int8"
    res = _run(tmp_path, "tiny.step5", t)
    assert not res["correct"], res["compared"]


def _driver(bench_dir, bench, name):
    from harness.cell import Cell, Record
    from harness.trace import Tracer
    import tempfile

    w, conf = run.cell_spec(bench, name)
    config = run.load_json(os.path.join(os.path.dirname(bench_dir), conf["file"]))
    traffic = run.load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    mod = run.load_module(os.path.join(bench_dir, "drivers", traffic["driver"] + ".py"),
                          "drivers_" + traffic["driver"])
    scratch = tempfile.mkdtemp()
    cell = Cell(name=name, config_name=w["config"], config=config, traffic_name=w["traffic"],
                traffic=traffic, seed=SEED, seconds=1.0, trace=False,
                device=torch.device("cpu"), scratch=scratch,
                record=Record(tracer=Tracer(False, scratch)))
    return mod.Driver(cell)


@pytest.mark.parametrize("stage,fault", [(st, f) for st, fs in faults.FAULTS.items()
                                          for f in fs])
def test_a_planted_fault_fails(tmp_path, stage, fault):
    traffic = {"step3": tiny.step3_traffic, "step4b": tiny.step4b_traffic,
               "step5": tiny.step5_traffic}[stage]()
    with faults.planted(fault, stage):
        res = _run(tmp_path, f"tiny.{stage}", traffic)
    assert not res["correct"], res["compared"]
    if (stage, fault) == ("step5", "state_unchanged"):
        assert res["compared"]["update_leaf_gap"]["value"] == pytest.approx(1.0)


def test_a_new_cell_and_metric_are_files_alone(tmp_path):
    """The tiny cell is a configuration file, a traffic file and entries;
    the metric below is one more reader file and entry.  No file of the
    benchmark is edited."""
    def add_metric(bench_dir):
        with open(os.path.join(bench_dir, "metrics", "groups_done.step3.py"), "w") as f:
            f.write("def read(record):\n    return record.counters.get('groups')\n")
        path = os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json")
        bench = json.load(open(path))
        bench["per_layer"].append({"name": "groups_done.step3", "unit": "groups",
                                   "better": "higher", "source": "program_counter",
                                   "layer": "pipeline", "moves": "img_tok_per_s",
                                   "workloads": ["tiny.step3"]})
        json.dump(bench, open(path, "w"))

    before = {p: open(p, "rb").read() for p in tiny.benchmark_files()}
    res = _run(tmp_path, "tiny.step3", tiny.step3_traffic(), trace=True, extra=add_metric)
    assert res["metrics"]["groups_done.step3"]["value"] >= 1
    assert "decode_step_ms.step3" in res["metrics"]
    assert before == {p: open(p, "rb").read() for p in tiny.benchmark_files()}
