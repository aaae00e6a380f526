"""Host milliseconds an image that the scoring engine spends handing work
to the device: the program's ``scoring.upload``, ``scoring.vit``,
``scoring.prefill`` and ``scoring.suffix`` spans over the images scored in
the window."""

from harness.program_spans import per_image_ms


def read(record):
    return per_image_ms(record, "scoring.upload", "scoring.vit", "scoring.prefill",
                        "scoring.suffix")
