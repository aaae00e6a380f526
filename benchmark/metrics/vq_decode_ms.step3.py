"""Device milliseconds a group in the VQ decode: the mean of the program's
``image.vq_decode`` spans (CUDA events around ``decode_code`` and the cast
to uint8 pixels) over the window's groups."""

from harness.program_spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "step3", "image.vq_decode", "device_s", "image.vq_decode")
