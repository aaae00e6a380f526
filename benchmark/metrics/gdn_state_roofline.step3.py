"""The gated-delta-rule decode kernel's least time over its device time in
the traced decode steps (every GDN layer of each; ``roofline/gated_delta.py``:
the recurrent and conv states once each way, the inputs and outputs)."""

from roofline import gated_delta, peaks


def read(record):
    s = record.tracer.summary if record.tracer else None
    w = record.work
    if s is None or w.get("stage") != "step3" or "gdn_layers" not in w:
        return None
    dev = s.kernel_seconds(gated_delta.KERNELS)
    if dev <= 0:
        return None
    least = peaks.least_time(*gated_delta.work(
        w["rows"], w["lin_k_heads"], w["lin_v_heads"], w["lin_k_dim"], w["lin_v_dim"],
        w["conv_kernel"], w["conv_bytes"]))
    return 100.0 * least * w["gdn_layers"] * w["traced_units"] / dev
