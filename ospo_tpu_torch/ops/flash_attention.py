"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version.

Counterpart of ``ospo_tpu/ops/flash_attention.py`` (forward only; the
backward kernels come with the training slice).  Semantics, shared by the
kernel and :func:`flash_attention_plain`:

- q ``[B, T, H, D]``, k / v ``[B, S, KVH, D]`` (GQA: query head ``h`` reads
  key/value head ``h // (H // KVH)``), mask ``[B, S]`` int32 key validity;
- fp32 scores ``(q * D^-0.5) . k``; masked keys score ``-1e30``; keys with
  ``j > i`` (causal, row-local as in the TPU kernel) or ``j >= S`` are
  excluded (probability 0);
- O is normalised by ``max(l, 1e-30)``; also returned are the row normaliser
  ``l`` and row max ``m``, ``[B, H, T]`` fp32.

A query row whose allowed keys are all masked (a left-pad row) gets the mean
of V over its causal window.  The TPU kernel averages over whole key tiles
there and ``xla_attention`` over all S keys, so only rows with a valid key
are compared with them.
"""

from __future__ import annotations

import torch

NEG_FILL = -1e30
HEAD_DIM = 128

launches = 0  # kernel launches since the last reset (main-path accounting)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, mask=None, causal=True):
    """Plain PyTorch version → (O [B,T,H,D] in q's dtype, l, m [B,H,T])."""
    B, T, H, D = q.shape
    S, kvh = k.shape[1], k.shape[2]
    if kvh != H:
        k = k.repeat_interleave(H // kvh, dim=2)
        v = v.repeat_interleave(H // kvh, dim=2)
    qf = q.float() * D ** -0.5
    s = torch.einsum("bthd,bshd->bhts", qf, k.float())
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s,
                        torch.full_like(s, NEG_FILL))
    if causal:
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    probs = p / l.clamp_min(1e-30)[..., None]
    out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return out.to(q.dtype), l, m


def flash_attention(q, k, v, mask=None, causal=True, return_stats=False):
    """Launch the CUDA kernel for CUDA tensors; the plain version for CPU
    tensors.  Returns O, or (O, l, m) with ``return_stats``."""
    global launches
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, mask, causal)
        return out if return_stats else out[0]
    from ospo_tpu_torch.ops import build

    B, T, H, D = q.shape
    S, kvh = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if D != HEAD_DIM or k.shape != (B, S, kvh, D) or v.shape != k.shape \
            or H % kvh:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}; the kernel "
                         f"takes head_dim {HEAD_DIM} and H divisible by KVH")
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.int32, device=q.device)
    if mask.dtype != torch.int32 or mask.shape != (B, S) \
            or mask.device != q.device:
        raise ValueError("flash_attention: mask must be int32 [B, S] on the "
                         "device of q")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    out = torch.empty_like(q)
    l = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = build.load("flash_fwd").ospo_flash_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             out.data_ptr(), l.data_ptr(), m.data_ptr(),
             B, T, S, H, kvh, D, int(bool(causal)), _DTYPES[q.dtype], stream)
    build.check(err, "flash_fwd")
    launches += 1
    return (out, l, m) if return_stats else out
