"""The least time of the window's groups (prefill, every decode step, the
head) over the window's host time (``roofline/mfu.py``)."""

from roofline import mfu


def read(record):
    w = record.work
    if w.get("stage") != "step3" or record.window_s <= 0:
        return None
    return 100.0 * sum(mfu.step3_group(w, t) for t in w["t_prompts"]) / record.window_s
