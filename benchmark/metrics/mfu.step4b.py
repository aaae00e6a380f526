"""The least time of the window's scoring chunks (``roofline/mfu.py``)
over the window's host time."""

from roofline import mfu


def read(record):
    w = record.work
    if w.get("stage") != "step4b" or record.window_s <= 0 or not w["chunks"]:
        return None
    return 100.0 * sum(mfu.step4b_chunk(w, c) for c in w["chunks"]) / record.window_s
