"""Host milliseconds an image that the scoring engine waits for its yes/no
readouts to come back (the ``.cpu()`` of each slice, which waits on the
slice's device work): the program's ``scoring.readback`` spans over the
images scored in the window."""

from harness.program_spans import per_image_ms


def read(record):
    return per_image_ms(record, "scoring.readback")
