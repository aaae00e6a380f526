"""The Kimi Delta Attention decode kernel's least time over its device time
in the traced decode steps (every KDA layer of each; ``roofline/kda.py``:
the recurrent and conv states once each way, the inputs and outputs)."""

from roofline import kda, peaks


def read(record):
    s = record.tracer.summary if record.tracer else None
    w = record.work
    if s is None or w.get("stage") != "step3" or "kda_layers" not in w:
        return None
    dev = s.kernel_seconds(kda.KERNELS)
    if dev <= 0:
        return None
    least = peaks.least_time(*kda.work(
        w["rows"], w["kda_heads"], w["kda_dim"], w["kda_dim"], w["conv_kernel"],
        w["conv_bytes"]))
    return 100.0 * least * w["kda_layers"] * w["traced_units"] / dev
