"""The roofline and mfu work functions against the kernel table's figures
(operations and bytes from shapes, each byte counted once)."""

from __future__ import annotations

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from roofline import decode_attention, flash_bwd, mfu, peaks  # noqa: E402


def test_decode_read_at_the_serving_point():
    """L=30 S=960 H=32 B=48, cur_len 672, int8 cache: 273.4 MB a layer."""
    flops, nbytes = decode_attention.work(48, 32, 128, 672, kv_bytes=1)
    assert nbytes / 1e6 == pytest.approx(273.4, abs=0.05)
    assert flops == 4 * 48 * 32 * 672 * 128


def test_flash_dq_at_the_training_shape():
    """rows 32, H 32, T=S=704: 195.2 GFLOP, 931.5 MB."""
    flops, nbytes = flash_bwd.dq_work(32, 32, 128, 704)
    assert flops / 1e9 == pytest.approx(195.2, abs=0.05)
    assert nbytes / 1e6 == pytest.approx(931.5, abs=0.05)


def test_flash_backward_operation():
    """Five products over the causal half; Q, K, V, dO, three row
    statistics and the mask in, dQ, dK, dV out."""
    flops, nbytes = flash_bwd.work(32, 32, 128, 704)
    assert flops == pytest.approx(5 / 3 * flash_bwd.dq_work(32, 32, 128, 704)[0])
    tensor = 32 * 32 * 704 * 128 * 2
    assert nbytes == 7 * tensor + 3 * 32 * 32 * 704 * 4 + 32 * 704 * 4


def _work_7b(**kw):
    w = dict(hidden=4096, ffn=11008, heads=32, kv_heads=32, head_dim=128, layers=30,
             image_vocab=16384)
    w.update(kw)
    return w


def test_step5_update_is_compute_bound_near_the_usual_count():
    """16 pairs at 672: 6·N·tokens is the usual count less the trunk's
    weight gradients (4·N here), ~0.5 PFLOP an update; attention, the head
    and the adapters add 5.3%."""
    w = _work_7b(rows=32, seq=672, lora_rank=32, lora_widths=4 * 8192 + 3 * (4096 + 11008))
    least = mfu.step5_update(w)
    n = 30 * (4 * 4096 * 4096 + 3 * 4096 * 11008)
    assert 1.04 < least / (4 * n * 32 * 672 / peaks.BF16_FLOPS) < 1.07


def test_step3_group_is_bound_by_bytes_in_decode():
    """A decode step moves the int8 trunk once (~6.1 GB) and the int8
    cache over the positions it reaches (8448 bytes a position, row and
    layer: ~8.5 GB at 700 positions of 48 rows): about 2 s a group at the
    memory's peak, far above the FLOPs' bound."""
    w = _work_7b(rows=48, n_img=576, weight_bytes=1, kv_bytes=1)
    least = mfu.step3_group(w, 128)
    trunk = 30 * (4 * 4096 * 4096 + 3 * 4096 * 11008)
    assert least > 575 * trunk / peaks.HBM_BYTES
    kv = 48 * 30 * 8448 * sum(128 + s for s in range(1, 576))
    prefill = 2 * trunk * 48 * 128 / peaks.BF16_FLOPS          # compute-bound
    assert least == pytest.approx(prefill + (575 * trunk + kv) / peaks.HBM_BYTES, rel=0.02)


def test_trace_reduction():
    """Busy time is the union of device intervals; kernel time sums by
    name; each gap goes to the innermost host op running at its middle."""
    from harness.trace import reduce_events

    k = lambda ts, dur, name="k": {"ph": "X", "cat": "kernel", "ts": ts, "dur": dur,  # noqa: E731
                                   "name": name}
    op = lambda ts, dur, name: {"ph": "X", "cat": "cpu_op", "ts": ts, "dur": dur,  # noqa: E731
                                "name": name, "tid": 1}
    events = [k(0, 10, "a"), k(5, 10, "b"), k(40, 10, "a"),
              op(0, 100, "outer"), op(20, 10, "aten::copy_")]
    s = reduce_events(events, window_s=100e-6)
    assert s.busy_s == pytest.approx(25e-6)
    assert s.kernel_s == pytest.approx({"a": 20e-6, "b": 10e-6})
    assert s.idle_by_host_op == pytest.approx({"aten::copy_": 25e-6})


def test_flash_forward_at_the_training_shape():
    """rows 32, H 32, T=S=704: 130.1 GFLOP, 744.1 MB."""
    from roofline import flash_fwd

    flops, nbytes = flash_fwd.work(32, 32, 128, 704)
    assert flops / 1e9 == pytest.approx(130.1, abs=0.05)
    assert nbytes / 1e6 == pytest.approx(744.1, abs=0.05)
