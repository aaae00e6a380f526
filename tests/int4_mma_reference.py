"""A CPU model of the bf16 tensor-core body of the int4 decode matmuls
(``int4_decode_mma`` in ``ospo_tpu_torch/ops/csrc/int4_matmul.cuh``), step by
step, for the CPU tests:

- the nibble decode by integer operations: bytes (0, 2, 1, 3) of each 32-bit
  word, then two nibbles at a time into the mantissas of bf16 128.0 with bit 3
  flipped, less 136 (:func:`decode_planes`);
- the group weights w = r(nib · r(gs)) from one bf16 multiply
  (:func:`plane_weights`);
- the permuted k of each 128-column chunk (:func:`k_order`) and the order of
  the fp32 sums: per k16 step, chunk after chunk in each half of the
  chunks' columns, the two halves added, then the blocks of a cluster in
  rank order (:func:`mma_decode_matmul`).  Inside one
  k16 step the tensor core's order of its 16 products is not modelled.
"""

from __future__ import annotations

import numpy as np
import torch

from ospo_tpu_torch.ops import int4_matmul as tint4

CHUNK = tint4.CHUNK   # 128 columns
MAGIC = 0x43084308   # bf16x2 (136, 136); also 128.0 with bit 3 of the mantissa


def _bf16(bits: np.ndarray) -> torch.Tensor:
    """16-bit patterns → bf16 tensor."""
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(
        torch.bfloat16)


def nibbles_bf16(w: np.ndarray, shift: int):
    """The kernel's ``nibbles_bf16``: (w >> shift) & 0x000F000F ^ MAGIC as a
    bf16 pair, less (136, 136) → (low half, high half) as bf16 tensors."""
    t = ((w >> np.uint32(shift)) & np.uint32(0x000F000F)) ^ np.uint32(MAGIC)
    k136 = torch.tensor(136.0, dtype=torch.bfloat16)
    return _bf16(t & 0xFFFF) - k136, _bf16(t >> 16) - k136


def byte_perm_3120(w: np.ndarray) -> np.ndarray:
    """``__byte_perm(w, 0, 0x3120)``: bytes (0, 2, 1, 3) of each word."""
    b = [(w >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    return b[0] | (b[2] << np.uint32(8)) | (b[1] << np.uint32(16)) | (
        b[3] << np.uint32(24))


def decode_planes(q4: torch.Tensor):
    """q4 ``[R, D]`` int8 (D a multiple of 4) → (low, high) planes ``[R, D]``
    in bf16, decoded as the kernel decodes its A fragments: of word j's
    permuted bytes, shift 0 gives columns 4j, 4j+1 of the low plane, shift 8
    columns 4j+2, 4j+3; shifts 4 and 12 the same of the high plane."""
    r, d = q4.shape
    words = np.ascontiguousarray(q4.numpy()).view(np.uint32).reshape(r, d // 4)
    p = byte_perm_3120(words)
    planes = []
    for s01, s23 in ((0, 8), (4, 12)):
        out = torch.empty((r, d // 4, 4), dtype=torch.bfloat16)
        out[..., 0], out[..., 1] = nibbles_bf16(p, s01)
        out[..., 2], out[..., 3] = nibbles_bf16(p, s23)
        planes.append(out.reshape(r, d))
    return planes[0], planes[1]


def plane_weights(nib: torch.Tensor, gs: torch.Tensor) -> torch.Tensor:
    """The kernel's group weights for one plane: the decoded bf16 nibble
    times the bf16-rounded scale of its 16 columns' group, one rounding of
    the exact product (a 4-bit integer times a bf16 value is exact in fp32)."""
    r, d = nib.shape
    group = d // gs.shape[-1]
    scale = gs.to(torch.bfloat16).float().repeat_interleave(group, dim=1)
    return (nib.float() * scale).to(torch.bfloat16)


def k_order() -> np.ndarray:
    """[2 halves, 4 k16 steps, 16 k slots] → the chunk column each slot
    takes.  Half h of a 128-column chunk (columns 64 h .. 64 h + 63) belongs
    to its own warps; lane (g, tig) holds slots 2tig, 2tig+1 (a0, b0) and
    2tig+8, 2tig+9 (a2, b1), and takes at step s columns 4s .. 4s + 3 of its
    own 16 contiguous bytes, 64 h + 16 tig .. 64 h + 16 tig + 15."""
    order = np.empty((2, 4, 16), np.int64)
    for h in range(2):
        for s in range(4):
            for k in range(16):
                tig, e = (k % 8) // 2, k % 2 + 2 * (k // 8)
                order[h, s, k] = 64 * h + 16 * tig + 4 * s + e
    return order


def cluster_chunks(d: int, n: int, rank: int) -> range:
    """The CHUNK-column chunks of D that block ``rank`` of a cluster of ``n``
    sums: the kernel's partition, [rank C / n, (rank + 1) C / n) of C."""
    chunks = -(-d // CHUNK)
    return range(rank * chunks // n, (rank + 1) * chunks // n)


def mma_decode_matmul(x: torch.Tensor, qw, nsplit: int | None = None,
                      return_acc: bool = False):
    """The bf16 body's function and sum order on the CPU: x ``[M, 1, D]``
    bf16 → y ``[M, 1, F]`` bf16 (``return_acc``: also the fp32 sums
    ``[M, F]`` before rounding).  ``nsplit`` defaults to the wrapper's
    cluster plan on a card that holds two blocks an SM on 132 SMs."""
    q4 = qw["q4"]
    f2, d = q4.shape
    m = x.shape[0]
    if nsplit is None:
        nsplit = tint4._clusters(m, f2, d, lambda n: 2 * 132 // n)
    low, high = decode_planes(q4)
    if "gs" in qw:
        low = plane_weights(low, qw["gs"][:f2])
        high = plane_weights(high, qw["gs"][f2:])
    chunks = -(-d // CHUNK)
    pad = chunks * CHUNK - d
    w = torch.nn.functional.pad(torch.cat([low, high]).float(), (0, pad))
    xs = torch.nn.functional.pad(x[:, 0, :].float(), (0, pad))
    order = torch.from_numpy(k_order())
    total = None
    for rank in range(nsplit):
        halves = []
        for h in range(2):
            acc = torch.zeros((2 * f2, m), dtype=torch.float32)
            for c in cluster_chunks(d, nsplit, rank):
                for s in range(4):
                    idx = c * CHUNK + order[h, s]
                    acc = acc + w[:, idx] @ xs[:, idx].T
            halves.append(acc)
        acc = halves[0] + halves[1]
        total = acc if total is None else total + acc
    acc = total.T
    if "gs" in qw:
        y = acc.to(torch.bfloat16)
    else:
        y = acc.to(torch.bfloat16) * qw["s"].to(torch.bfloat16)
    return (y[:, None, :], acc) if return_acc else y[:, None, :]
