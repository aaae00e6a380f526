"""Share of the question rows the suffix passes run that carry a question:
the program's ``scoring.suffix`` counters in the window, rows used (each
image's own question count) over rows run (the slice's question stack,
Q_b, times its images)."""

from harness.program_spans import window_spans


def read(record):
    if record.work.get("stage") != "step4b":
        return None
    spans = window_spans(record, "scoring.suffix")
    run = sum(s.attrs.get("rows_run", 0) for s in spans or ())
    if not run:
        return None
    return 100.0 * sum(s.attrs.get("rows_used", 0) for s in spans) / run
