"""A Qwen3-Next trunk's weight-only int8 projections' least time over the
device time of the kernel that does them, by name, in the traced decode
steps: every GDN and full-attention layer's projections of each step
(``roofline/w8a16_hybrid.py``).  A program without the kernel, or a cell
of another trunk, reads nothing."""

from roofline import w8a16_hybrid


def read(record):
    s = record.tracer.summary if record.tracer else None
    w = record.work
    if s is None or w.get("stage") != "step3" or w.get("trunk") != "gdn_moe" \
            or not w.get("trace_cur_lens"):
        return None
    dev = s.kernel_seconds(w8a16_hybrid.KERNELS)
    if dev <= 0:
        return None
    return 100.0 * w8a16_hybrid.least_step(w) * len(w["trace_cur_lens"]) / dev
