"""The work of one cached suffix step's attention (step 4b): ``t_b``
question rows of each of ``n`` images against the batch-shared prefix of
``c_pre`` stored rows (``pre_n`` of them valid) and the image's own
``p_b + t_b`` cache rows, int8 with fp32 scales, ``heads`` heads of
``head_dim``.

Operations, 2 FLOP a multiply-add of S = QKᵀ and O = PV: every question row
against the valid prefix and the image rows, and the causal triangle of the
suffix.  Bytes, each counted once: the int8 K and V of the ``n·(p_b + t_b)``
cache rows and their fp32 scales, the bf16 prefix K and V of ``c_pre``
rows, bf16 q in and out of ``n·t_b`` rows, the int32 key mask."""

# kernel name of the step in the profiler's trace
KERNELS = ("suffix_attention",)


def work(n: int, heads: int, head_dim: int, p_b: int, t_b: int, pre_n: int,
         c_pre: int):
    """→ (FLOPs, bytes) of one launch."""
    per_row = 4 * n * heads * head_dim * t_b
    flops = per_row * (pre_n + p_b) + per_row * (t_b + 1) // 2
    rows = n * (p_b + t_b)
    nbytes = (2 * rows * heads * (head_dim + 4) + 2 * c_pre * heads * head_dim * 2
              + 2 * n * t_b * heads * head_dim * 2 + rows * 4)
    return flops, nbytes
