"""Share of the traced decode steps' device-busy time spent in the MoE
kernels, by name: routing, grouping, the grouped expert GEMMs and the
combine (``moe_*``)."""

KERNELS = ("moe_route", "moe_align", "moe_gate_up", "moe_down", "moe_combine")


def read(record):
    s = record.tracer.summary if record.tracer else None
    if s is None or record.work.get("stage") != "step3" or s.busy_s <= 0:
        return None
    dev = s.kernel_seconds(KERNELS)
    if dev <= 0:
        return None
    return 100.0 * dev / s.busy_s
