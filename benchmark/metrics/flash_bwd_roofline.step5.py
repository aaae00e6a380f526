"""Causal attention's backward (dQ, dK, dV) in the traced training update:
its least time, every layer of every micro-batch, over the device time of
the kernels that compute it."""

from roofline import flash_bwd, peaks


def read(record):
    s = record.tracer.summary if record.tracer else None
    w = record.work
    if s is None or w.get("stage") != "step5":
        return None
    dev = s.kernel_seconds(flash_bwd.KERNELS)
    if dev <= 0:
        return None
    least = peaks.least_time(*flash_bwd.work(w["rows"], w["heads"], w["head_dim"],
                                             w["seq"])) * w["layers"]
    return 100.0 * least / dev
