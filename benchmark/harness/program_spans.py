"""The program's own spans (``ospo_tpu_torch.utils.profiling``) that lie
inside a run's window, for the per-layer readers.  A program without the
span recorder, or a window with none of the names, gives None."""

from __future__ import annotations


def window_spans(record, *names):
    """The spans named ``names`` that start and end inside
    ``record.window`` (``time.perf_counter``), device seconds resolved."""
    from ospo_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    w0, w1 = record.window
    if read is None or w1 <= w0:
        return None
    return [s for s in read(w0, w1) if s.name in names] or None


def per_unit_ms(record, stage: str, name: str, clock: str, unit_span: str):
    """Milliseconds of ``name`` spans (``clock``: ``host_s`` or
    ``device_s``) a unit: their sum over the count of ``unit_span`` spans
    in the window."""
    if record.work.get("stage") != stage:
        return None
    spans = window_spans(record, name, unit_span)
    units = [s for s in spans or () if s.name == unit_span]
    parts = [getattr(s, clock) for s in spans or () if s.name == name]
    if not units or not parts:
        return None
    return 1e3 * sum(parts) / len(units)


def per_image_ms(record, *names):
    """Host milliseconds of the ``names`` spans in the window over the
    images scored in it (the divisor of ``engine_ms_per_image.step4b``)."""
    n = record.work.get("images_scored") if record.work.get("stage") == "step4b" else None
    spans = window_spans(record, *names) if n else None
    if not spans:
        return None
    return 1e3 * sum(s.host_s for s in spans) / n
