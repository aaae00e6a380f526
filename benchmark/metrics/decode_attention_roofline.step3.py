"""The decode read's least time over the device time of the kernels that
do it, in the traced decode steps (every layer of each)."""

from roofline import decode_attention, peaks


def read(record):
    s = record.tracer.summary if record.tracer else None
    w = record.work
    if s is None or w.get("stage") != "step3":
        return None
    dev = s.kernel_seconds(decode_attention.KERNELS)
    if dev <= 0:
        return None
    least = sum(peaks.least_time(*decode_attention.work(
        w["rows"], w["kv_heads"], w["head_dim"], cur, w["kv_bytes"]))
        for cur in w["trace_cur_lens"]) * w["layers"]
    return 100.0 * least / dev
