"""The weight-only int8 projections' least time over the device time of the
kernel that does them, by name, in the traced decode steps: the seven
matrices of every layer of each step (``roofline/w8a16.py``).  A program
without the kernel reads nothing."""

from roofline import peaks, w8a16


def read(record):
    s = record.tracer.summary if record.tracer else None
    w = record.work
    if s is None or w.get("stage") != "step3" or not w.get("trace_cur_lens"):
        return None
    dev = s.kernel_seconds(w8a16.KERNELS)
    if dev <= 0:
        return None
    least = sum(peaks.least_time(*w8a16.work(w["rows"], f, d))
                for f, d in w8a16.matrices(w["hidden"], w["ffn"], w["heads"],
                                           w["kv_heads"], w["head_dim"]))
    return 100.0 * least * w["layers"] * len(w["trace_cur_lens"]) / dev
