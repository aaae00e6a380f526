"""The question suffixes' attention in the traced scoring call: its least
time over the device time of the kernel that does it, by name.  One launch a
layer and suffix pass of each slice (``layers × q_b × slices``), each a
cached step of the slice's question rows (``roofline/suffix_attention.py``).
A program without the kernel reads nothing."""

from roofline import mfu, peaks, suffix_attention


def read(record):
    s = record.tracer.summary if record.tracer else None
    w = record.work
    c = w.get("traced") if w.get("stage") == "step4b" else None
    if s is None or not c:
        return None
    dev = s.kernel_seconds(suffix_attention.KERNELS)
    if dev <= 0:
        return None
    slices, n = mfu.chunk_slices(c)
    one = suffix_attention.work(n, w["heads"], w["head_dim"], c["p_b"], c["t_b"],
                                c["pre_n"], c["c_pre"])
    return 100.0 * w["layers"] * c["q_b"] * slices * peaks.least_time(*one) / dev
