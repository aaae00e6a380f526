"""The least time of the window's groups on a KDA/MLA/MoE trunk (prefill,
every decode step, the head; ``roofline/mfu_kda.py``) over the window's
host time, with each group's held experts touched and held slots from its
``image.experts`` counters."""

from harness.program_spans import window_spans
from roofline import mfu_kda


def read(record):
    w = record.work
    if w.get("stage") != "step3" or "kda_layers" not in w or record.window_s <= 0:
        return None
    spans = window_spans(record, "image.experts")
    if not spans or len(spans) != len(w["t_prompts"]):
        return None
    least = sum(mfu_kda.step3_group(w, t, s.attrs)
                for t, s in zip(w["t_prompts"], spans))
    return 100.0 * least / record.window_s
