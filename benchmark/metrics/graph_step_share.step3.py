"""Share of the window's cached decode steps that replayed the trunk as a
CUDA graph: the program's ``image.trunk`` spans whose ``graph`` attr is 1,
over all of them.  None where no such span carries the attr (a program
without the graph)."""

from harness.program_spans import window_spans


def read(record):
    if record.work.get("stage") != "step3":
        return None
    trunk = window_spans(record, "image.trunk") or []
    flags = [s.attrs["graph"] for s in trunk if "graph" in s.attrs]
    if not flags:
        return None
    return 100.0 * sum(flags) / len(trunk)
