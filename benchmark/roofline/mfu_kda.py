"""The least time of a step-3 group on a KDA/MLA/MoE trunk (Kimi Linear),
for ``mfu_kda.step3``: ``roofline/mfu.py``'s rule (2 FLOP a multiply-add;
the weights once a pass; activations not counted; a pass's least time the
larger of its FLOPs at the bf16 peak and its bytes at the memory's peak)
over this trunk's work on this chip: ``roofline/mfu_moe.py``'s MLA and
experts with the KDA states' traffic beside them.

A pass reads the dense part of the trunk at one byte a parameter (every KDA
layer's q, k, v, the low-rank f_a, f_b, g_a, g_b, b and o projections;
every MLA layer's q, kv_a, kv_b and o; the dense layer's MLP; the shared
experts), the routers in bf16, the held routed experts it touches (one
byte a parameter; a decode step's mean from the group's ``image.experts``
counters, all of them in the prefill), the generation head and aligner in
bf16; a decode step reads and writes every KDA layer's recurrent state
(fp32) and conv state, and reads the MLA layers' latent cache over the
positions it reaches (``latent_bytes`` a value); the prefill writes them.
Operations a row: every dense parameter, the router, the held slots of its
top-k (the group's counters) and the head once; a KDA layer's conv and
delta rule (``2·3·H·D·K + 7·H·Dk·Dv``); an MLA layer's absorbed read
``2·Hm·(2R + dr)`` a cached position (the prefill's causal attention over
the expanded keys and values).
"""

from roofline.peaks import least_time


def _dims(w):
    d, H, D = w["hidden"], w["kda_heads"], w["kda_dim"]
    Hm, R, dr = w["q_heads"], w["kv_lora_rank"], w["rope_dim"]
    qd, dv = w["q_head_dim"], w["v_head_dim"]
    width = H * D
    kda = d * (3 * width + 2 * D + H) + 2 * D * width + width * d
    mla = d * Hm * qd + d * (R + dr) + R * Hm * (qd - dr + dv) + Hm * dv * d
    dense = (w["kda_layers"] * kda + w["mla_layers"] * mla
             + w["dense_layers"] * 3 * d * w["dense_ffn"]
             + w["moe_layers"] * 3 * d * w["shared_ffn"])
    router = w["moe_layers"] * w["routed_experts"] * d
    expert = 3 * d * w["expert_ffn"]
    head = d * d + d * w["image_vocab"]
    aligner = 8 * d + d * d
    mixer = w["kda_layers"] * (2 * 3 * width * w["conv_kernel"] + 7 * H * D * D)
    state = w["kda_layers"] * (H * D * D * w["state_bytes"]
                               + (w["conv_kernel"] - 1) * 3 * width * w["conv_bytes"])
    lat = w["mla_layers"] * (R + dr) * w["latent_bytes"]     # a row and position
    return dense, router, expert, head, aligner, mixer, state, lat


def step3_group(w: dict, t_prompt: int, experts: dict) -> float:
    """One CFG group of ``rows`` prompts of ``t_prompt`` positions, then
    ``n_img - 1`` cached steps; ``experts`` the group's ``image.experts``
    counters."""
    dense, router, expert, head, aligner, mixer, state, lat = _dims(w)
    Lm, Lmla, rows = w["moe_layers"], w["mla_layers"], w["rows"]
    Hm, R, dr = w["q_heads"], w["kv_lora_rank"], w["rope_dim"]
    steps = max(1, experts["steps"])
    held_k = experts["routed_rows"] / (steps * Lm * rows)
    fixed = dense + 2 * router + 2 * (head + aligner)
    per_row = dense + router + Lm * held_k * expert + head + aligner
    # prefill: every held expert touched, causal attention over the expanded
    # heads, the states and latent rows written
    tokens = rows * t_prompt
    pairs = rows * t_prompt * (t_prompt + 1) // 2
    flops = (2 * per_row * tokens + tokens * mixer
             + 2 * Lmla * Hm * (w["q_head_dim"] + w["v_head_dim"]) * pairs)
    total = least_time(flops, fixed + Lm * w["experts"] * expert + rows * state
                       + tokens * lat)
    touched = (experts["expert_slots"] - experts["idle_experts"]) / steps
    for s in range(1, w["n_img"]):
        cur = t_prompt + s
        flops = 2 * per_row * rows + rows * mixer + 2 * Lmla * rows * Hm * (2 * R + dr) * cur
        total += least_time(flops, fixed + touched * expert + 2 * rows * state
                            + rows * cur * lat)
    return total
