"""The least time of a step-3 group on an MLA/MoE trunk (DeepSeek-V2), for
``mfu_moe.step3``: ``roofline/mfu.py``'s rule (2 FLOP a multiply-add; the
weights once a pass; activations not counted; a pass's least time the
larger of its FLOPs at the bf16 peak and its bytes at the memory's peak)
over this trunk's active work.

A pass reads the dense part of the trunk (every layer's MLA projections,
the dense layers' MLP, the shared experts at one byte a parameter, the
routers in bf16), the routed experts it touches (one byte a parameter; a
decode step's mean from the group's ``image.experts`` counters, all of
them in the prefill), the generation head and aligner in bf16, and the
latent cache over the positions it reaches (``latent_bytes`` a value).
Operations a row: every dense parameter, the router, ``top_k`` experts and
the head once; a decode step's absorbed attention ``2·H·(2R + dr)`` a
cached position and layer; the prefill's causal attention over the
expanded keys (``q_head_dim``) and values (``v_head_dim``).
"""

from roofline.peaks import least_time


def _dims(w):
    d, H, R, dr = w["hidden"], w["heads"], w["kv_lora_rank"], w["rope_dim"]
    qd, dv = w["q_head_dim"], w["v_head_dim"]
    dn = qd - dr
    attn = d * H * qd + d * (R + dr) + R * H * (dn + dv) + H * dv * d
    expert = 3 * d * w["expert_ffn"]
    dense = (w["layers"] * attn + w["dense_layers"] * 3 * d * w["dense_ffn"]
             + w["moe_layers"] * 3 * d * w["shared_ffn"])
    router = w["moe_layers"] * w["experts"] * d
    head = d * d + d * w["image_vocab"]
    aligner = 8 * d + d * d
    return dense, router, expert, head, aligner


def step3_group(w: dict, t_prompt: int, experts: dict) -> float:
    """One CFG group of ``rows`` prompts of ``t_prompt`` positions, then
    ``n_img - 1`` cached steps; ``experts`` the group's ``image.experts``
    counters."""
    dense, router, expert, head, aligner = _dims(w)
    L, Lm, E, k = w["layers"], w["moe_layers"], w["experts"], w["top_k"]
    rows, H, R, dr = w["rows"], w["heads"], w["kv_lora_rank"], w["rope_dim"]
    lat = (R + dr) * w["latent_bytes"]
    fixed = dense + 2 * router + 2 * (head + aligner)
    per_row = dense + router + Lm * k * expert + head + aligner
    # prefill: every expert touched, causal attention over expanded heads
    tokens = rows * t_prompt
    pairs = rows * t_prompt * (t_prompt + 1) // 2
    flops = (2 * per_row * tokens
             + 2 * L * H * (w["q_head_dim"] + w["v_head_dim"]) * pairs)
    total = least_time(flops, fixed + Lm * E * expert + L * tokens * lat)
    steps = max(1, experts["steps"])
    touched = (experts["expert_slots"] - experts["idle_experts"]) / steps
    for s in range(1, w["n_img"]):
        cur = t_prompt + s
        flops = 2 * per_row * rows + 2 * L * rows * H * (2 * R + dr) * cur
        total += least_time(flops, fixed + touched * expert + L * rows * cur * lat)
    return total
