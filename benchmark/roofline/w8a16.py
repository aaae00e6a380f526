"""The work of a cached decode step's weight-only int8 projections: one
product of ``rows`` positions by an int8 ``[F, D]`` matrix with fp32 row
scales, for each of a LLaMA layer's seven matrices (q, k, v, o, gate, up,
down).

Operations: ``2 · rows · F · D`` (2 FLOP a multiply-add).  Bytes, each
once: the int8 payload (``F · D``), the fp32 scales (``4 F``), x in and y
out in bf16 (``2 · rows · (D + F)``)."""

# kernel name of the product in the profiler's trace
KERNELS = ("w8a16_matmul",)


def matrices(hidden: int, ffn: int, heads: int, kv_heads: int, head_dim: int):
    """(F, D) of a LLaMA layer's seven projections."""
    q, kv = heads * head_dim, kv_heads * head_dim
    return [(q, hidden), (kv, hidden), (kv, hidden), (hidden, q),
            (ffn, hidden), (ffn, hidden), (hidden, ffn)]


def work(rows: int, f: int, d: int):
    """→ (FLOPs, bytes) of one product."""
    return 2 * rows * f * d, f * d + 4 * f + 2 * rows * (d + f)
