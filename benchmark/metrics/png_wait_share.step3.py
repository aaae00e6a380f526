"""Share of the window the main thread waits on the PNG writers: the
program's ``step3.png_wait`` spans (backpressure on the third pending group
and the join at each ``run_step3`` call's end) over the window's host time."""

from harness.program_spans import window_spans


def read(record):
    if record.work.get("stage") != "step3" or record.window_s <= 0:
        return None
    spans = window_spans(record, "step3.png_wait")
    if not spans:
        return None
    return 100.0 * sum(s.host_s for s in spans) / record.window_s
