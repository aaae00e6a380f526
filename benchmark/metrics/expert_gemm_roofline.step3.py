"""The grouped expert kernels' least time over their device time in the
traced decode steps (every MoE layer of each): the rows a step sends
through them (each token's routed slots and its shared experts, which run
in the same launches as more experts every token takes), and the experts
touched a step and layer: the routed ones from the traced group's own
``image.experts`` counters (its mean over the group's steps), plus the
shared ones, touched every step."""

from roofline import expert_gemm, peaks


def read(record):
    s = record.tracer.summary if record.tracer else None
    w = record.work
    if s is None or w.get("stage") != "step3" or "experts" not in w:
        return None
    from ospo_tpu_torch.utils import profiling

    read_spans = getattr(profiling, "spans", None)
    traced = [x for x in (read_spans(record.window[1]) if read_spans else ())
              if x.name == "image.experts"]
    dev = s.kernel_seconds(expert_gemm.KERNELS)
    if not traced or dev <= 0:
        return None
    a = traced[-1].attrs
    per_layer_steps = a["steps"] * w["moe_layers"]
    shared = w.get("shared_experts", 0)
    touched = (a["expert_slots"] - a["idle_experts"]) / per_layer_steps + shared
    rows = w["rows"] * (w["top_k"] + shared)
    experts = w["experts"] + shared
    block_m = 16 if rows <= 16 * experts else 64
    least = peaks.least_time(*expert_gemm.work(
        rows, touched, w["hidden"], w["expert_ffn"], experts, block_m))
    return 100.0 * least * w["moe_layers"] * w["traced_units"] / dev
