"""How unevenly the window's decode steps route: the busiest expert's rows
(summed over steps and MoE layers) over the rows an expert would get under
even routing (routed rows over experts), from the program's
``image.experts`` counters of the window's groups."""

from harness.program_spans import window_spans


def read(record):
    w = record.work
    if w.get("stage") != "step3" or "experts" not in w:
        return None
    spans = window_spans(record, "image.experts")
    if not spans:
        return None
    routed = sum(s.attrs["routed_rows"] for s in spans)
    busiest = sum(s.attrs["busiest_rows"] for s in spans)
    return busiest / (routed / w["experts"]) if routed else None
