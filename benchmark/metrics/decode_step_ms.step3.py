"""Host milliseconds a decode step: from the first to the last
``step_hook`` of each group, summed over the window's groups, over all
their steps."""


def read(record):
    spans = record.work.get("hook_spans") if record.work.get("stage") == "step3" else None
    if not spans:
        return None
    return 1e3 * sum(s for s, _ in spans) / sum(n for _, n in spans)
