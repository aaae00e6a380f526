"""The weight-only int8 projections' work function and the reader of
``w8a16_roofline.step3`` (operations and bytes from shapes, each byte
counted once)."""

from __future__ import annotations

import importlib.util
import os
import sys
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness.trace import reduce_events  # noqa: E402
from roofline import peaks, w8a16  # noqa: E402

# the 7B trunk's shapes as a step-3 run's work record holds them
WORK_7B = dict(hidden=4096, ffn=11008, heads=32, kv_heads=32, head_dim=128)


def test_w8a16_projections_of_a_7b_step():
    """48 rows through the seven int8 matrices of 30 layers: 6.07 GB of
    payload, 1.81 ms at the memory's peak (x, y and the scales add 4%), far
    above the FLOPs' bound."""
    mats = w8a16.matrices(4096, 11008, 32, 32, 128)
    assert sum(f * d for f, d in mats) == 4 * 4096 * 4096 + 3 * 4096 * 11008
    least = 30 * sum(peaks.least_time(*w8a16.work(48, f, d)) for f, d in mats)
    payload = 30 * sum(f * d for f, d in mats)
    assert payload / 1e9 == pytest.approx(6.07, abs=0.005)
    assert 1.0 < least / (payload / peaks.HBM_BYTES) < 1.05
    flops, nbytes = w8a16.work(48, 11008, 4096)
    assert flops == 2 * 48 * 11008 * 4096
    assert nbytes == 11008 * 4096 + 4 * 11008 + 2 * 48 * (4096 + 11008)


def test_w8a16_reader_needs_the_kernel_in_the_trace():
    """The reader reads the kernel's device time by name; a trace without
    it (a program without the kernel) reads nothing; at the bytes' bound
    it reads 100%."""
    spec = importlib.util.spec_from_file_location(
        "w8a16_reader", os.path.join(BENCH, "metrics", "w8a16_roofline.step3.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    work = dict(WORK_7B, layers=2, stage="step3", rows=48, trace_cur_lens=[300, 301])
    least = 2 * 2 * sum(peaks.least_time(*w8a16.work(48, f, d))
                        for f, d in w8a16.matrices(4096, 11008, 32, 32, 128))

    def record(name, seconds):
        ev = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": seconds * 1e6, "name": name}]
        return SimpleNamespace(tracer=SimpleNamespace(summary=reduce_events(ev, 1.0)),
                               work=work)

    assert reader.read(record("Memcpy DtoD", least)) is None
    got = reader.read(record("void (anonymous namespace)::w8a16_matmul<6>(...)", least))
    assert got == pytest.approx(100.0)
