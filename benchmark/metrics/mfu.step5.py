"""The least time of the window's training updates (``roofline/mfu.py``)
over the window's host time."""

from roofline import mfu


def read(record):
    w = record.work
    if w.get("stage") != "step5" or record.window_s <= 0:
        return None
    return 100.0 * w["updates"] * mfu.step5_update(w) / record.window_s
