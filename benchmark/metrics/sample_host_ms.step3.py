"""Host milliseconds a decode step in sampling: the mean of the program's
``image.sample`` spans (each step's head, CFG combine, sampling and next
image embedding) over the window's groups."""

from harness.program_spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "step3", "image.sample", "host_s", "image.sample")
