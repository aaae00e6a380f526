"""Decode attention over the stacked batch-minor KV cache: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

Counterpart of ``ospo_tpu/ops/decode_attention.py``.  Semantics, shared by
the kernel and :func:`decode_attention_plain`:

- q ``[B, 1, H, dh]``; caches ``[L, S, H, B, dh]`` (bf16, or int8 with
  ``[L, S, H, B]`` fp32 scales; the plain version also takes f32); mask
  ``[B, S]`` int32 key validity;
- only positions ``[0, cur_len)`` of layer ``layer_idx`` are read;
- fp32 scores ``(q * dh^-0.5) . k``, times the k scale for an int8 cache;
  masked keys score ``-1e30``;
- softmax normaliser ``l`` over the unscaled probabilities; for an int8 cache
  the v scale multiplies each probability after ``l`` has taken it;
- ``cur_len == 0`` outputs zeros.  MHA only (the cache has H heads).

A row whose populated keys are all masked gets the mean of (scaled) V over
``[0, cur_len)``.  The TPU kernel averages over whole position blocks there,
which agrees whenever ``cur_len`` is a multiple of its block.
"""

from __future__ import annotations

import torch

NEG_FILL = -1e30
HEAD_DIM = 128
CHUNK = 64  # positions per warp in the kernel's first pass

launches = 0  # kernel launches since the last reset (main-path accounting)

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.bfloat16: 0, torch.int8: 1}  # the kernel's caches


def decode_attention_plain(q, k_cache, v_cache, layer_idx, cur_len, mask,
                           k_scale=None, v_scale=None):
    """Plain PyTorch version → [B, 1, H, dh] in q's dtype."""
    B, _, H, dh = q.shape
    if cur_len == 0:
        return torch.zeros_like(q)
    k = k_cache[layer_idx, :cur_len].float()               # [C, H, B, dh]
    v = v_cache[layer_idx, :cur_len].float()
    qf = q[:, 0].float() * dh ** -0.5                       # [B, H, dh]
    s = torch.einsum("bhd,chbd->bhc", qf, k)
    if k_scale is not None:
        s = s * k_scale[layer_idx, :cur_len].permute(2, 1, 0)
    valid = (mask[:, None, :cur_len] > 0)
    s = torch.where(valid, s, torch.full_like(s, NEG_FILL))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[layer_idx, :cur_len].permute(2, 1, 0)
    out = torch.einsum("bhc,chbd->bhd", p, v)
    return out.to(q.dtype)[:, None]


def decode_attention(q, k_cache, v_cache, layer_idx, cur_len, mask,
                     k_scale=None, v_scale=None):
    """Launch the CUDA kernel for CUDA tensors; the plain version for CPU
    tensors.  ``layer_idx`` and ``cur_len`` are host integers."""
    global launches
    layer_idx, cur_len = int(layer_idx), int(cur_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, layer_idx, cur_len,
                                      mask, k_scale, v_scale)
    from ospo_tpu_torch.ops import build

    B, T, H, dh = q.shape
    L, S = k_cache.shape[0], k_cache.shape[1]
    quantized = k_cache.dtype == torch.int8
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("mask", mask)]
    if quantized:
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in tensors:
        if t is None or t.device != q.device or q.device.type != "cuda":
            raise ValueError(f"decode_attention: {name} must lie on the CUDA "
                             f"device of q")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if q.dtype not in _Q_DTYPES or k_cache.dtype not in _KV_DTYPES \
            or v_cache.dtype != k_cache.dtype or mask.dtype != torch.int32:
        raise ValueError(f"decode_attention: dtypes q {q.dtype}, cache "
                         f"{k_cache.dtype}/{v_cache.dtype}, mask {mask.dtype}")
    if T != 1 or dh != HEAD_DIM or k_cache.shape != (L, S, H, B, dh) \
            or v_cache.shape != k_cache.shape or mask.shape != (B, S):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, mask {tuple(mask.shape)}; "
                         f"the kernel takes T=1, head_dim {HEAD_DIM}, an shbd "
                         f"cache [L,S,H,B,dh] and a [B,S] mask")
    if quantized and (k_scale.dtype != torch.float32
                      or k_scale.shape != (L, S, H, B)
                      or v_scale.shape != k_scale.shape
                      or v_scale.dtype != torch.float32):
        raise ValueError("decode_attention: int8 caches need float32 scales "
                         "[L, S, H, B]")
    if not (0 <= layer_idx < L and 0 <= cur_len <= S):
        raise ValueError(f"decode_attention: layer {layer_idx} of {L}, "
                         f"cur_len {cur_len} of {S}")
    n_split = max(1, -(-cur_len // CHUNK))
    out = torch.empty_like(q)
    part_ml = torch.empty((n_split, H * B, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((n_split, H * B, dh), dtype=torch.float32,
                           device=q.device)
    ks = k_scale.data_ptr() if quantized else None
    vs = v_scale.data_ptr() if quantized else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = build.load("decode_attention").ospo_decode_attention
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ks, vs,
             mask.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
             part_acc.data_ptr(), S, H, B, dh, layer_idx, cur_len, CHUNK,
             n_split, _Q_DTYPES[q.dtype], _KV_DTYPES[k_cache.dtype], stream)
    build.check(err, "decode_attention")
    launches += 1
    return out
