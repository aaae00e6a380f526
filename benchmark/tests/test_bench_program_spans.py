"""The readers of the program's own spans, on the CPU: each tiny cell run
with ``trace`` reports every span metric of its stage, and the parts add up
to what the outside metrics read (step 3: trunk and sampling to the host's
time a decode step; step 4b: enqueue and readback to the engine's time an
image; step 5: the four phases to the window's time an update), and the
suffix rows used over run equal a count of the traffic by hand."""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, BENCH, os.path.dirname(BENCH)]

import run  # noqa: E402
import tiny  # noqa: E402

SEED = 4_294_967_311

SPAN_METRICS = {
    "step3": ["trunk_host_ms", "sample_host_ms", "vq_decode_ms", "png_wait_share"],
    "step4b": ["prep_wait_ms_per_image", "enqueue_ms_per_image", "readback_ms_per_image",
               "suffix_row_use"],
    "step5": ["vq_encode_ms", "forward_ms", "backward_ms", "optimizer_ms"],
}


def _window_per_update(bench_dir):
    """A reader of the window's milliseconds an update, for the step-5 sum."""
    with open(os.path.join(bench_dir, "metrics", "window_ms_per_update.step5.py"), "w") as f:
        f.write("def read(record):\n"
                "    return 1e3 * record.window_s / record.work['updates']\n")
    path = os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "window_ms_per_update.step5", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "pipeline", "moves": "train_pairs_per_s",
                               "workloads": ["tiny.step5"]})
    with open(path, "w") as f:
        json.dump(bench, f)


def _traced(tmp_path, stage):
    traffic = {"step3": tiny.step3_traffic, "step4b": tiny.step4b_traffic,
               "step5": tiny.step5_traffic}[stage]()
    name = f"tiny.{stage}"
    bench_dir = tiny.make_tree(str(tmp_path), {name: (name.replace(".", "-"), traffic)})
    if stage == "step5":
        _window_per_update(bench_dir)
    with open(os.path.join(str(tmp_path), "BENCHMARK.json")) as f:
        bench = json.load(f)
    torch.manual_seed(0)
    res = run.run_cell(bench, name, SEED, 1.0, True, device="cpu", bench_dir=bench_dir)
    assert res["correct"], res["compared"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for metric in SPAN_METRICS[stage]:
        assert f"{metric}.{stage}" in m, (metric, sorted(m))
    return m, traffic


def _suffix_rows(traffic):
    """Rows run and used by one call: six images an item (its question
    count each), sorted, chunks of ``score_rows``, the last padded by
    repeating its last image; a chunk runs its largest count for every
    image."""
    step4b = run.load_module(os.path.join(BENCH, "drivers", "step4b.py"), "drivers_step4b")
    counts = sorted(n for n in step4b._spread(traffic["question_counts"],
                                              int(traffic["items_per_call"]))
                    for _ in range(6))
    rows = int(traffic["score_rows"])
    chunks = [counts[i:i + rows] for i in range(0, len(counts), rows)]
    chunks = [c + [c[-1]] * (rows - len(c)) for c in chunks]
    return sum(rows * max(c) for c in chunks), sum(sum(c) for c in chunks)


def test_step3_trunk_and_sampling_make_the_decode_step(tmp_path):
    m, _ = _traced(tmp_path, "step3")
    parts = m["trunk_host_ms.step3"] + m["sample_host_ms.step3"]
    assert parts == pytest.approx(m["decode_step_ms.step3"], rel=0.05)
    assert m["vq_decode_ms.step3"] > 0
    assert 0 <= m["png_wait_share.step3"] <= m["pipeline_host_share.step3"]


def test_step4b_enqueue_and_readback_make_the_engine_time(tmp_path):
    m, traffic = _traced(tmp_path, "step4b")
    parts = m["enqueue_ms_per_image.step4b"] + m["readback_ms_per_image.step4b"]
    assert parts == pytest.approx(m["engine_ms_per_image.step4b"], rel=0.10)
    run_rows, used = _suffix_rows(traffic)
    assert m["suffix_row_use.step4b"] == pytest.approx(100.0 * used / run_rows)
    assert m["prep_wait_ms_per_image.step4b"] >= 0


def test_step5_phases_make_the_update(tmp_path):
    m, _ = _traced(tmp_path, "step5")
    parts = sum(m[f"{p}.step5"] for p in SPAN_METRICS["step5"])
    assert parts == pytest.approx(m["window_ms_per_update.step5"], rel=0.03)
