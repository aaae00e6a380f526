"""Device milliseconds an update in ``train.backward``: the program's CUDA
events around ``autograd.grad`` of the trained leaves, summed over the
window and divided by its updates (``train.update`` spans)."""

from harness.program_spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "step5", "train.backward", "device_s", "train.update")
