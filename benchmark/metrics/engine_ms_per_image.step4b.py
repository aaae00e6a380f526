"""Milliseconds inside the scoring engine's ``score_images_multi`` calls
(host spans of the benchmark's engine subclass; each call returns its
scores to the host) over the images scored in the window."""


def read(record):
    n = record.work.get("images_scored") if record.work.get("stage") == "step4b" else None
    if not n:
        return None
    return 1e3 * record.span_seconds("engine") / n
