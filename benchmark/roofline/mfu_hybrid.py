"""The least time of a step-3 group on a GDN/MoE trunk (Qwen3-Next), for
``mfu_hybrid.step3``: ``roofline/mfu.py``'s rule (2 FLOP a multiply-add;
the weights once a pass; activations not counted; a pass's least time the
larger of its FLOPs at the bf16 peak and its bytes at the memory's peak)
over this trunk's work on this chip, ``roofline/mfu_moe.py``'s with the
GDN state's traffic and the GQA window in place of the latent window.

A pass reads the dense part of the trunk (every GDN layer's ``in_proj_qkvz``,
``in_proj_ba`` and ``out_proj``, every full layer's q (with its gate), k,
v and o, the shared experts, at one byte a parameter; the routers with the
shared gates' rows in bf16), the held routed experts it touches (one byte
a parameter; a decode step's mean from the group's ``image.experts``
counters, all of them in the prefill), the generation head and aligner in
bf16; a decode step reads and writes every GDN layer's recurrent state
(fp32) and conv state, and reads the full layers' keys and values over the
positions it reaches (``kv_bytes`` a value); the prefill writes them.
Operations a row: every dense parameter, the router, the held slots of
its top-k (the group's counters) and the head once; a GDN layer's conv
and delta rule (``2·C·K + 7·Hv·Dk·Dv``); a full layer's attention
``2·2·H·Dh`` a position it reads (the prefill's causal pairs).
"""

from roofline.peaks import least_time


def _dims(w):
    d, H, Hkv, Dh = w["hidden"], w["q_heads"], w["kv_heads"], w["head_dim"]
    hk, hv, dk, dv = w["lin_k_heads"], w["lin_v_heads"], w["lin_k_dim"], w["lin_v_dim"]
    channels = 2 * hk * dk + hv * dv
    gdn = d * (channels + hv * dv + 2 * hv) + hv * dv * d
    full = d * 2 * H * Dh + 2 * d * Hkv * Dh + H * Dh * d
    dense = (w["gdn_layers"] * gdn + w["full_layers"] * full
             + w["moe_layers"] * 3 * d * w["shared_ffn"])
    router = w["moe_layers"] * (w["routed_experts"] + 1) * d
    expert = 3 * d * w["expert_ffn"]
    head = d * d + d * w["image_vocab"]
    aligner = 8 * d + d * d
    mixer = w["gdn_layers"] * (2 * channels * w["conv_kernel"] + 7 * hv * dk * dv)
    state = w["gdn_layers"] * (hv * dk * dv * w["state_bytes"]
                               + (w["conv_kernel"] - 1) * channels * w["conv_bytes"])
    kv = w["full_layers"] * 2 * Hkv * Dh * w["kv_bytes"]      # a row and position
    return dense, router, expert, head, aligner, mixer, state, kv


def step3_group(w: dict, t_prompt: int, experts: dict) -> float:
    """One CFG group of ``rows`` prompts of ``t_prompt`` positions, then
    ``n_img - 1`` cached steps; ``experts`` the group's ``image.experts``
    counters."""
    dense, router, expert, head, aligner, mixer, state, kv = _dims(w)
    Lm, Lf, rows = w["moe_layers"], w["full_layers"], w["rows"]
    attn = 2 * 2 * w["q_heads"] * w["head_dim"]               # a position read, a layer
    steps = max(1, experts["steps"])
    held_k = experts["routed_rows"] / (steps * Lm * rows)
    fixed = dense + 2 * router + 2 * (head + aligner)
    per_row = dense + router + Lm * held_k * expert + head + aligner
    # prefill: every held expert touched, causal attention, the states written
    tokens = rows * t_prompt
    pairs = rows * t_prompt * (t_prompt + 1) // 2
    flops = 2 * per_row * tokens + tokens * mixer + Lf * attn * pairs
    total = least_time(flops, fixed + Lm * w["experts"] * expert + rows * state
                       + tokens * kv)
    touched = (experts["expert_slots"] - experts["idle_experts"]) / steps
    for s in range(1, w["n_img"]):
        cur = t_prompt + s
        flops = 2 * per_row * rows + rows * mixer + Lf * attn * rows * cur
        total += least_time(flops, fixed + touched * expert + 2 * rows * state
                            + rows * cur * kv)
    return total
