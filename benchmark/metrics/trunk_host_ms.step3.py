"""Host milliseconds a decode step in the trunk: the mean of the program's
``image.trunk`` spans (each cached step's ``language_forward``: embeds in,
last hidden state out, every layer enqueued) over the window's groups."""

from harness.program_spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "step3", "image.trunk", "host_s", "image.trunk")
