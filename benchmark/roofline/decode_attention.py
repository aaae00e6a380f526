"""The work of one layer's cached decode read: ``rows`` queries of one
position, each over ``cur_len`` cached positions of ``heads`` heads.

Counted once each: the cache's keys and values over ``cur_len`` positions
(``kv_bytes`` a value, plus an fp32 scale a position and head when
quantized), the int32 mask over ``cur_len`` positions, the queries read and
the outputs written (``q_bytes`` a value).  Operations: ``q·k`` and
``p·v``, 2 FLOP a multiply-add."""

# kernel names of the decode read in the profiler's trace
KERNELS = ("decode_partial", "decode_combine")


def work(rows: int, heads: int, head_dim: int, cur_len: int,
         kv_bytes: int, q_bytes: int = 2):
    """→ (FLOPs, bytes)."""
    kv = 2 * rows * heads * cur_len * head_dim * kv_bytes
    if kv_bytes < 2:
        kv += 2 * rows * heads * cur_len * 4
    qo = 2 * rows * heads * head_dim * q_bytes
    mask = rows * cur_len * 4
    flops = 2 * 2 * rows * heads * cur_len * head_dim
    return flops, kv + qo + mask
