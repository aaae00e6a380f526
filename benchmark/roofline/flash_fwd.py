"""The work of causal attention's forward over ``rows`` sequences of
``seq`` stored positions, ``valid`` of them real (left padding masked),
``heads`` heads.

Operations over the causal half of the real positions: S = QKᵀ and O = PV,
2 FLOP a multiply-add.  Bytes, each counted once: Q, K, V read and O
written (``nbytes`` a value), the int32 key mask read, the fp32 row
statistics (m, l) written."""

KERNELS = ("flash_fwd",)


def work(rows: int, heads: int, head_dim: int, seq: int, valid: int = None,
         nbytes: int = 2):
    """→ (FLOPs, bytes)."""
    valid = seq if valid is None else valid
    tensor = rows * heads * seq * head_dim * nbytes
    flops = 2 * 2 * rows * heads * (valid * (valid + 1) // 2) * head_dim
    return flops, 4 * tensor + rows * seq * 4 + 2 * rows * heads * seq * 4
