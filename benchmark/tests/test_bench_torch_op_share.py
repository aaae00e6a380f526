"""The reader of ``torch_op_share.step3``: PyTorch's own kernels
(``at::native`` in the name) over the traced steps' busy time."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness.trace import reduce_events  # noqa: E402


def _reader():
    spec = importlib.util.spec_from_file_location(
        "torch_op_share_reader", os.path.join(BENCH, "metrics", "torch_op_share.step3.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader


def _record(kernels, stage="step3"):
    """A trace of back-to-back kernels (name, µs) and a run's work record."""
    ev, t = [], 0.0
    for name, us in kernels:
        ev.append({"ph": "X", "cat": "kernel", "ts": t, "dur": us, "name": name})
        t += us
    return SimpleNamespace(tracer=SimpleNamespace(summary=reduce_events(ev, 1.0)),
                           work={"stage": stage})


def test_the_share_of_pytorchs_own_kernels():
    """30 of 100 busy µs in ``at::native`` kernels read 30%; the program's
    kernels, cuBLAS's and a copy count only in the busy time."""
    got = _reader().read(_record([
        ("void (anonymous namespace)::w8a16_matmul<6>(...)", 40.0),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<...>>", 12.0),
        ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, ...>>", 10.0),
        ("void (anonymous namespace)::add_rms_norm(...)", 5.0),
        ("nvjet_tst_128x64_64x8_1x1_v_bz_TNN", 25.0),
        ("void at::native::index_elementwise_kernel<128, 4, ...>", 8.0)]))
    assert got == pytest.approx(30.0)
    assert _reader().read(_record([("void (anonymous namespace)::silu_mul(...)", 9.0)])) == 0.0


@pytest.mark.parametrize("stage", ["step4b", "step5", None])
def test_nothing_outside_step_3(stage):
    record = _record([("void at::native::reduce_kernel<...>", 10.0)], stage=stage)
    assert _reader().read(record) is None


def test_nothing_without_a_trace():
    reader = _reader()
    assert reader.read(SimpleNamespace(tracer=None, work={"stage": "step3"})) is None
    assert reader.read(SimpleNamespace(tracer=SimpleNamespace(summary=None),
                                       work={"stage": "step3"})) is None


def test_the_metric_lists_the_four_step_3_cells():
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    m = {m["name"]: m for m in bench["per_layer"]}["torch_op_share.step3"]
    assert (m["unit"], m["better"], m["layer"], m["moves"]) == ("%", "lower", "kernels",
                                                                  "img_tok_per_s")
    steps = [w["name"] for w in bench["workloads"] if w["name"].endswith(".step3")]
    assert m["workloads"] == steps and len(steps) == 4
