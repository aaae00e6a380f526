"""Host milliseconds an image that ``run_scoring`` waits on its prefetch
thread (PNG decode and ``prepare_shared_multi`` of the next chunk): the
program's ``step4.prep_wait`` spans over the images scored in the window."""

from harness.program_spans import per_image_ms


def read(record):
    return per_image_ms(record, "step4.prep_wait")
