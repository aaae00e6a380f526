"""Device milliseconds an update in ``train.vq_encode``: the program's CUDA
events around the pixels' upload, their normalization and the VQ encoder's
ids (no gradient), summed over the window and divided by its updates
(``train.update`` spans)."""

from harness.program_spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "step5", "train.vq_encode", "device_s", "train.update")
