"""Share of the traced decode steps' device-busy time spent in the Kimi
Delta Attention decode kernel (``kda_decode``: the KDA layers' convs,
gates, recurrent state update and gated norm)."""

from roofline import kda


def read(record):
    s = record.tracer.summary if record.tracer else None
    if s is None or record.work.get("stage") != "step3" or s.busy_s <= 0:
        return None
    dev = s.kernel_seconds(kda.KERNELS)
    if dev <= 0:
        return None
    return 100.0 * dev / s.busy_s
