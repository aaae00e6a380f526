"""The suffix step's work function and the reader of
``suffix_attention_roofline.step4b`` (operations and bytes from shapes,
each byte counted once)."""

from __future__ import annotations

import importlib.util
import os
import sys
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness.trace import reduce_events  # noqa: E402
from roofline import peaks, suffix_attention  # noqa: E402

# the 1B trunk's attention widths as a step-4b run's work record holds them
WORK_1B = dict(stage="step4b", layers=24, heads=16, head_dim=128)
# a traced chunk: 16 images over a budget that fits 13 (2 slices of 8),
# 3 questions, prefix bucket 640, suffix bucket 240, pre-image 43 of 48 rows
CHUNK = dict(n=16, p_b=640, q_b=3, t_b=240, c_pre=48, pre_n=43, budget=12288,
             row_tokens=880)


def _reader():
    spec = importlib.util.spec_from_file_location(
        "suffix_reader", os.path.join(BENCH, "metrics",
                                      "suffix_attention_roofline.step4b.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader


def _record(name, seconds, work):
    ev = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": seconds * 1e6, "name": name}]
    return SimpleNamespace(tracer=SimpleNamespace(summary=reduce_events(ev, 1.0)),
                           work=work)


def test_suffix_step_work_by_hand():
    """8 images, 16 heads, 240 question rows after 640 image rows and 43 of
    48 prefix rows: 12.64 GFLOP (QKᵀ and PV over 683 rows, the triangle of
    240), 45.9 MB (29.7 MB of int8 window and scales, 15.7 MB of q and out,
    0.5 MB of prefix, 28 kB of mask); the bytes bound it (13.7 us)."""
    flops, nbytes = suffix_attention.work(8, 16, 128, 640, 240, 43, 48)
    assert flops == 4 * 8 * 16 * 128 * 240 * 683 + 4 * 8 * 16 * 128 * 240 * 241 // 2
    assert flops / 1e9 == pytest.approx(12.64, abs=0.005)
    assert nbytes == (2 * 8 * 880 * 16 * 132 + 2 * 48 * 16 * 128 * 2
                      + 2 * 8 * 240 * 16 * 128 * 2 + 8 * 880 * 4)
    assert nbytes / 1e6 == pytest.approx(45.9, abs=0.05)
    assert peaks.least_time(flops, nbytes) == pytest.approx(nbytes / peaks.HBM_BYTES)


@pytest.mark.parametrize("case", ["no trace", "another stage", "no traced chunk",
                                  "no such kernel", "no device time"])
def test_suffix_reader_reads_nothing_without_the_kernel(case):
    """No tracer, a step-3 or step-5 record, a run without a traced chunk,
    a trace without the kernel (a program that reads the suffixes
    otherwise) or a kernel with no device time: nothing to read."""
    reader = _reader()
    work = dict(WORK_1B, traced=dict(CHUNK))
    name, seconds = "void (anonymous namespace)::suffix_attention<true>(...)", 1e-3
    if case == "no trace":
        rec = SimpleNamespace(tracer=None, work=work)
    else:
        if case == "another stage":
            work["stage"] = "step3"
        elif case == "no traced chunk":
            work["traced"] = None
        elif case == "no such kernel":
            name = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8"
        else:
            seconds = 0.0
        rec = _record(name, seconds, work)
    assert reader.read(rec) is None


def test_suffix_reader_at_the_least_time_reads_100():
    """A kernel time equal to the traced launches' least time (24 layers x
    3 passes x 2 slices of 8 images) reads 100%; at twice it, 50%: the
    share cannot pass 100% for a kernel that does the counted work."""
    reader = _reader()
    least = 24 * 3 * 2 * peaks.least_time(*suffix_attention.work(8, 16, 128, 640, 240,
                                                                 43, 48))
    work = dict(WORK_1B, traced=dict(CHUNK))
    name = "void (anonymous namespace)::suffix_attention<true>(...)"
    assert reader.read(_record(name, least, work)) == pytest.approx(100.0)
    assert reader.read(_record(name, 2 * least, work)) == pytest.approx(50.0)
