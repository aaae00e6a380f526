"""The flash forward's launches in the traced scoring call: their least
time over the device time of the kernel.  On the shared-prefix path each
launch is one layer's prefill of the pre-image segment (one row); without
that segment, of a slice's image prefixes."""

from roofline import flash_fwd, mfu, peaks


def read(record):
    s = record.tracer.summary if record.tracer else None
    w = record.work
    c = w.get("traced") if w.get("stage") == "step4b" else None
    if s is None or not c or not w["traced_flash"]:
        return None
    dev = s.kernel_seconds(flash_fwd.KERNELS)
    if dev <= 0:
        return None
    if c["c_pre"]:
        one = flash_fwd.work(1, w["heads"], w["head_dim"], c["c_pre"], c["pre_n"])
    else:
        one = flash_fwd.work(mfu.chunk_slices(c)[1], w["heads"], w["head_dim"], c["p_b"])
    return 100.0 * w["traced_flash"] * peaks.least_time(*one) / dev
