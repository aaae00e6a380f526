"""The benchmark's files against its contract: names and units, the files
each entry needs, the metrics each cell reports, the import rules, and the
refusal to run without a card."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        for mod in _modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "ospo_tpu"), (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "reference")):
        for mod in _modules(path):
            assert mod.split(".")[0] != "ospo_tpu_torch", (path, mod)


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and "\n" not in w["why"]
        names += [w["name"], w["config"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for n in names:
        assert NAME.match(n), n
    assert len({c["name"] for c in bench["configs"]}) == len(bench["configs"])
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_entry_has_its_files(bench):
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"])), c
    for w in bench["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.exists(os.path.join(BENCH, "drivers", driver + ".py"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m


def test_each_cell_reports_setup_another_metric_and_a_layer(bench):
    sys.path.insert(0, BENCH)
    import run

    e2e = {m["name"] for m in bench["end_to_end"]}
    used = set()
    for w in bench["workloads"]:
        mine = {m["name"] for m in run.metrics_for(bench, "end_to_end", w["name"])}
        assert "setup_s" in mine and len(mine) >= 2, w
        layers = run.metrics_for(bench, "per_layer", w["name"])
        assert layers, w
        for m in layers:
            assert m["moves"] in mine and m["moves"] in e2e, (w, m)
        used.add(w["config"])
    assert used == {c["name"] for c in bench["configs"]}


def test_no_card_no_result():
    """Without a card: a message, a non-zero exit, nothing on stdout."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = bench["workloads"][0]["name"]
    proc = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "card" in proc.stderr or "CUDA" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's folder alone."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           bench["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
