"""W4A16 decode matmul (T == 1) over packed int4 weights: the CUDA kernels
``csrc/int4_matmul_row.cu`` and ``csrc/int4_matmul_group.cu`` and their
plain PyTorch version.

Counterpart of ``ospo_tpu/ops/int4_matmul.py`` (the TPU kernels
``_row_kernel`` :76 and ``_group_kernel`` :87).  The function, shared by the
kernels and :func:`int4_matmul_decode_plain`, is the TPU kernels' own:

- x ``[M, 1, D]`` in bf16 or fp32; ``q4`` ``[F/2, D]`` int8, output row i in
  the low nibble and row i + F/2 in the high nibble (``ops/quant.py``);
- ``{"q4", "s"}`` (per row): acc = x · nib summed in fp32, rounded to x's
  dtype, then times the row scale in x's dtype: y = r(r(acc) · r(s));
- ``{"q4", "gs"}`` (groups of D / G columns): each weight is formed in x's
  dtype as w = r(nib · r(gs[row, d // group])) and y = r(Σ x · w), the sum in
  fp32 (``r`` rounds to x's dtype).

bf16 x runs on the tensor cores (nibbles decoded to bf16 in registers,
``mma.sync``, split-K summed inside a thread-block cluster); fp32 x runs on
the CUDA cores with a second pass over fp32 partials (``csrc/int4_matmul.cuh``).

The reference's XLA forms (``quant.quantized_matmul_int4[_group]``) differ
from the group variant by about 2^-9 relative in bf16; in fp32 all agree to
fp32 rounding.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ospo_tpu_torch.ops.quant import unpack_int4_halves
from ospo_tpu_torch.utils.profiling import count_launch

MAX_ROWS = 256       # M the kernels take
ALIGN = 16           # D must be a multiple of this (16-byte weight loads)
TILE_ROWS = 64       # packed rows (128 output columns) per block, both bodies
TILE_M = 64          # rows of x per block, both bodies
K_STEP = 32          # fp32 body: columns per stage; a split is a multiple
CHUNK = 128          # bf16 body: columns per stage; a split is whole chunks
MAX_CLUSTER = 8      # bf16 body: blocks of a cluster (the portable limit)
TARGET_BLOCKS = 264  # fp32 body: two blocks for each of the H100's 132 SMs

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def group_weights(nib: torch.Tensor, gs: torch.Tensor, dtype: torch.dtype
                  ) -> torch.Tensor:
    """One plane's weights in ``dtype``: w = r(nib · r(gs)) for nib
    ``[R, D]`` and its rows' group scales ``gs`` ``[R, G]``."""
    r, d = nib.shape
    g = gs.shape[-1]
    w = nib.to(dtype).reshape(r, g, d // g) * gs.to(dtype)[:, :, None]
    return w.reshape(r, d)


def int4_matmul_decode_plain(x: torch.Tensor, qw: Dict[str, torch.Tensor]
                             ) -> torch.Tensor:
    """Plain PyTorch version → [M, 1, F] in x's dtype."""
    x2 = x[:, 0, :].float()
    low, high = unpack_int4_halves(qw["q4"])
    f2 = qw["q4"].shape[0]
    if "gs" in qw:
        gs = qw["gs"]

        def plane(nib, scale):
            w = group_weights(nib, scale, x.dtype)
            return (x2 @ w.float().T).to(x.dtype)

        y = torch.cat([plane(low, gs[:f2]), plane(high, gs[f2:])], dim=-1)
    else:
        s = qw["s"].to(x.dtype)
        y = torch.cat([(x2 @ low.float().T).to(x.dtype) * s[:f2],
                       (x2 @ high.float().T).to(x.dtype) * s[f2:]], dim=-1)
    return y[:, None, :]


def _splits(m: int, f2: int, d: int):
    """Split of D across blocks of the fp32 body so that the grid holds
    about TARGET_BLOCKS blocks: → (columns per split, a multiple of K_STEP;
    number of splits)."""
    tiles = -(-f2 // TILE_ROWS) * -(-m // TILE_M)
    want = max(1, min(-(-d // K_STEP), -(-TARGET_BLOCKS // tiles)))
    per = -(-d // want)
    per = -(-per // K_STEP) * K_STEP
    return per, -(-d // per)


def _clusters(m: int, f2: int, d: int, capacity: Callable[[int], int]) -> int:
    """Split of D for the bf16 body: the blocks of one output tile form a
    cluster of this many blocks, 1 to MAX_CLUSTER and no more than D has
    CHUNK-column chunks.  ``capacity(n)`` is how many clusters of n blocks the
    card holds at once; the split is the largest whose grid runs in one wave
    (1 when even single blocks need more than one)."""
    tiles = -(-f2 // TILE_ROWS) * -(-m // TILE_M)
    chunks = -(-d // CHUNK)
    best = 1
    for n in range(2, min(MAX_CLUSTER, chunks) + 1):
        if tiles <= capacity(n):
            best = n
    return best


def _card_capacity(name: str, lib, m: int, device) -> Callable[[int], int]:
    """``capacity`` for :func:`_clusters` from the card's occupancy of the
    bf16 body for M = m (``cudaOccupancyMaxActiveClusters``)."""
    query = getattr(lib, f"ospo_{name}_clusters")

    def capacity(n: int) -> int:
        with torch.cuda.device(device):
            got = query(m, n)
        if got < 0:
            raise RuntimeError(f"{name}: occupancy query failed with "
                               f"cudaError {-got}")
        return got

    return capacity


_plans: Dict[tuple, int] = {}   # (device, kernel, M, F/2, D) → split of D


def int4_matmul_decode(x: torch.Tensor, qw: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
    """y = x @ Wᵀ for T == 1 with W packed int4 (``{"q4", "s"}`` or
    ``{"q4", "gs"}``): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  On CUDA the kernel takes M ≤ 256, D a multiple of 16
    and, for groups, a group size that is a multiple of 16; anything else
    raises."""
    if x.device.type == "cpu":
        return int4_matmul_decode_plain(x, qw)
    from ospo_tpu_torch.ops import build

    group = "gs" in qw
    scale = qw["gs"] if group else qw["s"]
    q4 = qw["q4"]
    name = "int4_matmul_group" if group else "int4_matmul_row"
    if x.device.type != "cuda" or q4.device != x.device \
            or scale.device != x.device:
        raise ValueError(f"{name}: x, q4 and the scales must lie on one CUDA "
                         "device")
    if x.dtype not in _X_DTYPES or q4.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise ValueError(f"{name}: dtypes x {x.dtype}, q4 {q4.dtype}, scales "
                         f"{scale.dtype}; the kernel takes bf16/fp32 x, int8 "
                         "q4 and fp32 scales")
    if x.dim() != 3 or x.shape[1] != 1 or q4.dim() != 2 \
            or q4.shape[1] != x.shape[2]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, q4 {tuple(q4.shape)}; "
                         "the kernel takes x [M, 1, D] and q4 [F/2, D]")
    m, d = x.shape[0], x.shape[2]
    f2 = q4.shape[0]
    if not 1 <= m <= MAX_ROWS or d % ALIGN:
        raise ValueError(f"{name}: M={m}, D={d}; the kernel takes 1 <= M <= "
                         f"{MAX_ROWS} and D a multiple of {ALIGN}")
    if group:
        n_groups = scale.shape[-1]
        if scale.shape != (2 * f2, n_groups) or d % n_groups \
                or (d // n_groups) % ALIGN:
            raise ValueError(f"{name}: gs {tuple(scale.shape)} for q4 "
                             f"{tuple(q4.shape)}; the kernel takes gs [F, G] "
                             f"with D/G a multiple of {ALIGN}")
    elif scale.shape != (2 * f2,):
        raise ValueError(f"{name}: s {tuple(scale.shape)} for q4 "
                         f"{tuple(q4.shape)}; the kernel takes s [F]")
    for what, t in (("x", x), ("q4", q4), ("scales", scale)):
        if not t.is_contiguous() or t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: {what} must be contiguous and "
                             f"{ALIGN}-byte aligned")
    y = torch.empty((m, 1, 2 * f2), dtype=x.dtype, device=x.device)
    lib = build.load(name)
    if x.dtype == torch.float32:    # CUDA cores, partials through `part`
        per, n_split = _splits(m, f2, d)
        part = (torch.empty((n_split, m, 2 * f2), dtype=torch.float32,
                            device=x.device) if n_split > 1 else y)
    else:                           # tensor cores, split-K inside a cluster
        key = (x.device.index, name, m, f2, d)
        n_split = _plans.get(key)
        if n_split is None:
            n_split = _plans[key] = _clusters(
                m, f2, d, _card_capacity(name, lib, m, x.device))
        per, part = 0, y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if group:
        err = lib.ospo_int4_matmul_group(
            x.data_ptr(), q4.data_ptr(), scale.data_ptr(), y.data_ptr(),
            part.data_ptr(), m, f2, d, n_groups, per, n_split,
            _X_DTYPES[x.dtype], stream)
    else:
        err = lib.ospo_int4_matmul_row(
            x.data_ptr(), q4.data_ptr(), scale.data_ptr(), y.data_ptr(),
            part.data_ptr(), m, f2, d, per, n_split, _X_DTYPES[x.dtype],
            stream)
    build.check(err, name)
    count_launch("int4_matmul_group" if group else "int4_matmul_row")
    return y
