"""The reader of ``graph_step_share.step3``, on the CPU: the share of the
window's ``image.trunk`` spans that replayed the trunk as a CUDA graph."""

from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, BENCH, os.path.dirname(BENCH)]

import run  # noqa: E402
from harness.cell import Record  # noqa: E402

from ospo_tpu_torch.utils.profiling import span  # noqa: E402


def test_graph_step_share_reads_the_trunk_spans_graph_attr():
    """``graph_step_share.step3`` is None where no ``image.trunk`` span
    carries ``graph`` (a program without the trunk graph), 100 where every
    one replayed, and the replayed share of a mix."""
    reader = run.load_module(os.path.join(BENCH, "metrics", "graph_step_share.step3.py"),
                             "metrics_graph_step_share")

    def window(*attrs):
        t0 = time.perf_counter()
        for a in attrs:
            with span("image.trunk", **a):
                pass
        return Record(window=(t0, time.perf_counter()), work={"stage": "step3"})

    assert reader.read(window({}, {})) is None
    assert reader.read(window({"graph": 1}, {"graph": 1})) == 100.0
    assert reader.read(window({"graph": 0}, {"graph": 1}, {"graph": 1},
                              {"graph": 1})) == 75.0
    assert reader.read(Record(window=(0.0, 1.0), work={"stage": "step5"})) is None
