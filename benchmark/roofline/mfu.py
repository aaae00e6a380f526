"""The least time of a whole stage's work, for the ``mfu.*`` metrics.

Both formulas count, from the shapes the traffic fixes, the model's
FLOPs (2 a multiply-add) and the bytes it must move: the weights once a
forward pass and the attention's keys and values once a pass.
Activations are not counted.  A pass's least time is the larger of its
FLOPs at the bf16 peak and its bytes at the memory's peak; a stage's is the
sum over its passes.

Trunk parameters a layer: the q, k, v, o projections and the three FFN
matrices.  The generation head is Linear(D, D) and Linear(D, V_img); the
generation aligner Linear(8, D) and Linear(D, D).
"""

from roofline.peaks import least_time


def _dims(w):
    d, f, h, kvh, dh = (w["hidden"], w["ffn"], w["heads"], w["kv_heads"],
                        w["head_dim"])
    layer = d * h * dh + 2 * d * kvh * dh + h * dh * d + 3 * d * f
    head = d * d + d * w["image_vocab"]
    aligner = 8 * d + d * d
    return layer, head, aligner


def step3_group(w: dict, t_prompt: int) -> float:
    """One CFG group: the prefill of ``rows`` prompts of ``t_prompt``
    positions, then ``n_img - 1`` cached steps of ``rows`` tokens; the head
    on every step's last position.  Weights: the trunk at ``weight_bytes``
    a parameter (scales not counted), head and aligner in bf16.  Keys and
    values at ``kv_bytes`` a value (+ an fp32 scale a position and head
    when quantized), read over the positions each step reaches."""
    layer, head, aligner = _dims(w)
    L, rows, dh = w["layers"], w["rows"], w["head_dim"]
    h, kvh = w["heads"], w["kv_heads"]
    wbytes = L * layer * w["weight_bytes"] + 2 * (head + aligner)
    kv_pos = 2 * kvh * dh * w["kv_bytes"] + (8 * kvh if w["kv_bytes"] < 2 else 0)
    # prefill: causal attention over the prompt, the head on the last row
    flops = (2 * L * layer * rows * t_prompt
             + 4 * L * rows * h * dh * t_prompt * (t_prompt + 1) // 2
             + 2 * head * rows)
    nbytes = wbytes + L * rows * t_prompt * kv_pos
    total = least_time(flops, nbytes)
    for s in range(1, w["n_img"]):
        cur = t_prompt + s
        flops = (2 * (L * layer + head + aligner) * rows
                 + 4 * L * rows * h * dh * cur)
        nbytes = wbytes + L * rows * cur * kv_pos
        total += least_time(flops, nbytes)
    return total


def step5_update(w: dict) -> float:
    """One training update of ``rows`` sequences of ``seq`` positions
    (text bucket + image tokens), causal, no padding: the forward and the
    input-gradient backward of the frozen trunk (2 + 2 FLOP a parameter and
    token), attention forward (QKᵀ, PV) and backward (dV, dP, dQ, dK; the
    recompute of S not counted), the generation head forward and input
    gradient on every position, and the LoRA adapters (r·(d_in + d_out) a
    projection and token: forward, input gradient, weight gradient).  The
    frozen trunk's weight gradients and the layers' recompute are not
    counted.  Weights: bf16, once for the forward and once for the
    backward."""
    layer, head, _ = _dims(w)
    L, rows, seq, dh, h = w["layers"], w["rows"], w["seq"], w["head_dim"], w["heads"]
    tokens = rows * seq
    pairs = seq * (seq + 1) // 2
    lora = w["lora_rank"] * w["lora_widths"]
    flops = (4 * L * layer * tokens
             + (2 + 4) * 2 * L * rows * h * dh * pairs
             + 4 * head * tokens
             + 3 * 2 * L * lora * tokens)
    nbytes = 2 * 2 * (L * layer + head)
    return least_time(flops, nbytes)


def chunk_slices(c: dict):
    """The engine's slicing of a chunk of ``n`` images under its row-token
    budget: (slices, images a slice)."""
    fit = max(1, c["budget"] // c["row_tokens"]) if c["row_tokens"] > 0 else c["n"]
    if c["n"] <= fit:
        return 1, c["n"]
    slices = -(-c["n"] // fit)
    return slices, -(-c["n"] // slices)


def step4b_chunk(w: dict, c: dict) -> float:
    """One shared-prefix scoring chunk (``c``: images ``n``, prefix bucket
    ``p_b``, suffix bucket ``t_b``, questions ``q_b``, pre-image segment
    ``pre_n`` of ``c_pre`` stored positions), slice by slice: the SigLIP
    tower and aligner on each image (576 patches; bf16 weights), the
    pre-image prefill of one row, the image prefill of every image's prefix,
    and ``q_b`` suffix passes with the text head on their last position
    (int8 trunk, bf16 head).  Keys and values read once a pass: the
    pre-image segment in bf16, the rest int8 with fp32 scales."""
    L, d, dh, h = w["layers"], w["hidden"], w["head_dim"], w["heads"]
    trunk = L * (4 * d * h * dh + 3 * d * w["ffn"])
    vw, vl, vm, t = w["vit_width"], w["vit_layers"], w["vit_mlp"], w["image_tokens"]
    vit_params = vl * (4 * vw * vw + 2 * vw * vm) + vw * d + d * d
    head = d * w["vocab"]
    kv_pre = L * 2 * h * dh * 2
    kv_int8 = L * (2 * h * dh + 8 * h)
    slices, rows = chunk_slices(c)
    pre_n, p_b, t_b = c["pre_n"], c["p_b"], c["t_b"]
    total = 0.0
    for _ in range(slices):
        vit = rows * (2 * t * vit_params + 4 * vl * t * t * vw)
        total += least_time(vit, 2 * vit_params)
        if c["c_pre"]:
            total += least_time(2 * trunk * pre_n + 4 * L * h * dh * pre_n * (pre_n + 1) // 2,
                                trunk * w["weight_bytes"] + pre_n * kv_pre)
        flops = 2 * trunk * rows * p_b + 4 * L * h * dh * rows * (
            p_b * pre_n + p_b * (p_b + 1) // 2)
        total += least_time(flops, trunk * w["weight_bytes"] + pre_n * kv_pre
                            + rows * p_b * kv_int8)
        for _ in range(c["q_b"]):
            flops = (2 * trunk * rows * t_b + 2 * head * rows
                     + 4 * L * h * dh * rows * t_b * (pre_n + p_b + t_b))
            total += least_time(flops, trunk * w["weight_bytes"] + 2 * head + pre_n * kv_pre
                                + rows * (p_b + t_b) * kv_int8)
    return total
