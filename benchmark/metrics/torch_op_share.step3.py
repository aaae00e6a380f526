"""Share of the traced decode steps' device-busy time spent in PyTorch's own
kernels (name holds ``at::native``: its elementwise, reduce, copy and index
kernels), the ops a step leaves to PyTorch between the program's
hand-written kernels."""

KERNELS = ("at::native",)


def read(record):
    s = record.tracer.summary if record.tracer else None
    if s is None or record.work.get("stage") != "step3" or s.busy_s <= 0:
        return None
    return 100.0 * s.kernel_seconds(KERNELS) / s.busy_s
