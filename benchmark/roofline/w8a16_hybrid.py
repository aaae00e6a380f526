"""The weight-only int8 projections of a cached decode step of a Qwen3-Next
trunk, which ``w8a16_matmul`` runs: a Gated DeltaNet layer's
``in_proj_qkvz``, ``in_proj_ba`` and ``out_proj``, a gated full-attention
layer's ``q_proj`` (query and gate), ``k_proj``, ``v_proj`` and
``o_proj``.  The experts, the shared one included, run in the grouped
expert kernels, and the routers stay bf16, so neither is counted here.
Each product's work is ``roofline/w8a16.py``'s."""

from roofline import w8a16

# kernel name of the product in the profiler's trace
KERNELS = w8a16.KERNELS


def gdn_matrices(hidden: int, k_heads: int, v_heads: int, dk: int, dv: int):
    """(F, D) of a GDN layer's three projections."""
    ratio = v_heads // k_heads
    qkvz = k_heads * (2 * dk + 2 * ratio * dv)
    return [(qkvz, hidden), (2 * v_heads, hidden), (hidden, v_heads * dv)]


def full_matrices(hidden: int, heads: int, kv_heads: int, head_dim: int):
    """(F, D) of a gated full-attention layer's four projections."""
    kv = kv_heads * head_dim
    return [(2 * heads * head_dim, hidden), (kv, hidden), (kv, hidden),
            (hidden, heads * head_dim)]


def least_step(w: dict) -> float:
    """The least time of one decode step's products of ``rows`` rows, from a
    step-3 driver's ``work`` of this trunk."""
    from roofline import peaks

    rows = w["rows"]
    gdn = gdn_matrices(w["hidden"], w["lin_k_heads"], w["lin_v_heads"], w["lin_k_dim"],
                       w["lin_v_dim"])
    full = full_matrices(w["hidden"], w["q_heads"], w["kv_heads"], w["head_dim"])
    return (w["gdn_layers"] * sum(peaks.least_time(*w8a16.work(rows, f, d)) for f, d in gdn)
            + w["full_layers"] * sum(peaks.least_time(*w8a16.work(rows, f, d))
                                     for f, d in full))
