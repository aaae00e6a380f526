"""Device milliseconds an update in ``train.optimizer``: the program's CUDA
events around the gradients' reduction, their norm and AdamW, summed over
the window and divided by its updates (``train.update`` spans)."""

from harness.program_spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "step5", "train.optimizer", "device_s", "train.update")
