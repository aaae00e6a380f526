"""The work of causal attention's backward over ``rows`` sequences of
``seq`` positions (queries and keys alike), ``heads`` heads.

The operation, whichever kernels compute it: from Q, K, V, dO (``nbytes``
a value), the forward's fp32 row statistics (m, l) and the fp32 row sums
D = rowsum(dO·O), and the int32 key mask, it produces dQ, dK and dV.
Operations over the causal half, ``seq·(seq+1)/2`` query-key pairs a head:
S = QKᵀ again, dV = Pᵀ·dO, dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q, five products
of 2 FLOP a multiply-add.  Bytes: every input read once, every output
written once.

``dq_work`` is the dQ kernel's own share (S, dP and dQ; its inputs and dQ),
as the kernel table counts it."""

KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")


def _pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def work(rows: int, heads: int, head_dim: int, seq: int, nbytes: int = 2):
    """→ (FLOPs, bytes) of dQ, dK and dV together."""
    tensor = rows * heads * seq * head_dim * nbytes
    stats = 3 * rows * heads * seq * 4
    mask = rows * seq * 4
    flops = 5 * 2 * rows * heads * _pairs(seq) * head_dim
    return flops, 4 * tensor + stats + mask + 3 * tensor


def dq_work(rows: int, heads: int, head_dim: int, seq: int, nbytes: int = 2):
    """→ (FLOPs, bytes) of the dQ kernel alone."""
    tensor = rows * heads * seq * head_dim * nbytes
    stats = 3 * rows * heads * seq * 4
    mask = rows * seq * 4
    flops = 3 * 2 * rows * heads * _pairs(seq) * head_dim
    return flops, 4 * tensor + stats + mask + tensor
