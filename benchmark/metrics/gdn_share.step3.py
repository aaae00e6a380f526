"""Share of the traced decode steps' device-busy time spent in the
gated-delta-rule decode kernel (``gdn_decode``: the GDN layers' conv,
gates, recurrent state update and gated norm)."""

from roofline import gated_delta


def read(record):
    s = record.tracer.summary if record.tracer else None
    if s is None or record.work.get("stage") != "step3" or s.busy_s <= 0:
        return None
    dev = s.kernel_seconds(gated_delta.KERNELS)
    if dev <= 0:
        return None
    return 100.0 * dev / s.busy_s
