"""A cached T > 1 attention step over the batch-minor KV cache with a
batch-shared prefix: the CUDA kernel ``csrc/suffix_attention.cu`` and its
plain PyTorch version.

Step 4b's question suffixes make such a step: every question of a chunk
runs as T rows at ``cache["length"]`` against the image rows already in the
cache, after the pre-image prefix.  Semantics, shared by the kernel and
:func:`suffix_attention_plain` (which is ``attention.xla_attention`` over the
``shbd`` window, the path every other cached T > 1 read keeps):

- q ``[B, T, H, dh]`` at absolute rows ``[cur_len, cur_len + T)``, one
  ``cur_len`` for every row;
- the prefix ``prefix_k`` / ``prefix_v`` ``[C, H, dh]`` with ``prefix_mask``
  ``[C]``, ``[1, C]`` or ``[B, C]`` (no causal test), then rows
  ``[0, cur_len + T)`` of layer ``layer_idx`` of ``[L, S, H, B, dh]`` caches
  (bf16, or int8 with ``[L, S, H, B]`` fp32 scales) under the ``[B, >=
  cur_len + T]`` mask and the causal rule key ``j <= cur_len + t``;
- fp32 scores ``(q . k) * dh^-0.5 * k_scale``, ``-1e30`` for every
  disallowed key, one softmax over ``[prefix ++ own]``, the v scale folded
  into the probabilities.  A row with no allowed key averages V over every
  key of the prefix and the window.

The kernel rounds ``p * v_scale`` to fp16 (relative to a power of two at or
above the v scales) for the int8 rows' P . V: the one rounding the plain
form does not have.
"""

from __future__ import annotations

import torch

from ospo_tpu_torch.utils.profiling import count_launch

HEAD_DIM = 128
_KV_DTYPES = {torch.bfloat16: 0, torch.int8: 1}


def suffix_attention_takes(q, kv_cache, per_row: bool = False,
                           prefix_k=None) -> bool:
    """Whether a cached step of the queries ``q`` ``[B, T, H, dh]`` over
    ``kv_cache`` runs the kernel: bf16 q on the card, T > 1, dh 128, one
    offset for every row, an ``shbd`` cache of H heads (MHA) with a bf16 or
    an int8 payload (int8 with its scales), and a bf16 prefix ``[C, H, dh]``
    on the same device where there is one.  Everything else (the CPU, the
    ``bshd`` and ``bhsd`` layouts, int4, per-row offsets, GQA, another head
    dim or dtype) keeps the plain form."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16 or len(q.shape) != 4 \
            or per_row or kv_cache.get("layout", "shbd") != "shbd":
        return False
    B, T, H, dh = q.shape
    k = kv_cache["k"]
    if T < 2 or dh != HEAD_DIM or len(k.shape) != 5 or tuple(k.shape[2:]) != (H, B, dh) \
            or k.dtype not in _KV_DTYPES or k.device != q.device:
        return False
    if k.dtype == torch.int8 and (
            "k_s" not in kv_cache
            or tuple(kv_cache["k_s"].shape) != tuple(k.shape[:4])):
        return False
    return prefix_k is None or (prefix_k.dtype == torch.bfloat16
                                and prefix_k.device == q.device
                                and tuple(prefix_k.shape[1:]) == (H, dh))


def suffix_attention_plain(q, k_cache, v_cache, layer_idx, cur_len, mask,
                           prefix_k=None, prefix_v=None, prefix_mask=None,
                           k_scale=None, v_scale=None):
    """Plain PyTorch version: ``xla_attention`` over the ``shbd`` window
    ``[0, cur_len + T)`` → [B, T, H, dh] in q's dtype."""
    from ospo_tpu_torch.ops.attention import xla_attention

    window = cur_len + q.shape[1]
    k, v = k_cache[layer_idx, :window], v_cache[layer_idx, :window]
    if k_scale is not None:
        k = {"q": k, "s": k_scale[layer_idx, :window].permute(2, 1, 0)}
        v = {"q": v, "s": v_scale[layer_idx, :window].permute(2, 1, 0)}
    return xla_attention(q, k, v, mask[:, :window], cur_len, True, prefix_k,
                         prefix_v, prefix_mask, kv_layout="shbd")


def suffix_attention(q, k_cache, v_cache, layer_idx, cur_len, mask,
                     prefix_k=None, prefix_v=None, prefix_mask=None,
                     k_scale=None, v_scale=None):
    """Launch the CUDA kernel for CUDA tensors; the plain version for CPU
    tensors.  ``layer_idx`` and ``cur_len`` are host integers."""
    layer_idx, cur_len = int(layer_idx), int(cur_len)
    if q.device.type == "cpu":
        return suffix_attention_plain(q, k_cache, v_cache, layer_idx, cur_len,
                                      mask, prefix_k, prefix_v, prefix_mask,
                                      k_scale, v_scale)
    from ospo_tpu_torch.ops import build

    B, T, H, dh = q.shape
    L, S = k_cache.shape[0], k_cache.shape[1]
    quantized = k_cache.dtype == torch.int8
    C = 0 if prefix_k is None else prefix_k.shape[0]
    if q.dtype != torch.bfloat16 or k_cache.dtype not in _KV_DTYPES \
            or v_cache.dtype != k_cache.dtype \
            or (C and (prefix_k.dtype, prefix_v.dtype) != (q.dtype, q.dtype)):
        raise ValueError(f"suffix_attention: dtypes q {q.dtype}, cache "
                         f"{k_cache.dtype}/{v_cache.dtype}; the kernel takes bf16 "
                         f"q and prefix and a bf16 or int8 cache")
    if T < 2 or dh != HEAD_DIM or tuple(k_cache.shape) != (L, S, H, B, dh) \
            or v_cache.shape != k_cache.shape or mask.shape[0] != B \
            or (C and (tuple(prefix_k.shape) != (C, H, dh)
                       or prefix_v.shape != prefix_k.shape)):
        raise ValueError(f"suffix_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, mask {tuple(mask.shape)}; the "
                         f"kernel takes T > 1, head_dim {HEAD_DIM}, an shbd cache "
                         f"[L,S,H,B,dh], a [B, S] mask and a [C, H, dh] prefix")
    if quantized and (k_scale is None or v_scale is None
                      or tuple(k_scale.shape) != (L, S, H, B)
                      or v_scale.shape != k_scale.shape
                      or (k_scale.dtype, v_scale.dtype) != (torch.float32,) * 2):
        raise ValueError("suffix_attention: int8 caches need float32 scales "
                         "[L, S, H, B]")
    if not (0 <= layer_idx < L and 0 <= cur_len and cur_len + T <= min(S, mask.shape[1])):
        raise ValueError(f"suffix_attention: layer {layer_idx} of {L}, rows "
                         f"[0, {cur_len + T}) of {S} (mask {mask.shape[1]})")
    q = q.contiguous()
    mask = mask.to(torch.int32).contiguous()
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("mask", mask)]
    if quantized:
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    pk = pv = pm = None
    pm_ld = 0
    if C:
        pm = (torch.ones((1, C), dtype=torch.int32, device=q.device)
              if prefix_mask is None else prefix_mask.to(torch.int32).contiguous())
        pm = pm.reshape(1, C) if pm.ndim == 1 else pm
        if pm.shape not in ((1, C), (B, C)):
            raise ValueError(f"suffix_attention: prefix mask {tuple(pm.shape)} "
                             f"for a prefix of {C} rows and {B} images")
        pm_ld = 0 if pm.shape[0] == 1 else C
        pk, pv = prefix_k, prefix_v
        tensors += [("prefix_k", pk), ("prefix_v", pv), ("prefix_mask", pm)]
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"suffix_attention: {name} must lie on the CUDA "
                             f"device of q")
        if not t.is_contiguous() or t.data_ptr() % (16 if t.element_size() < 4 else 4):
            raise ValueError(f"suffix_attention: {name} must be contiguous and "
                             f"aligned (16 bytes for the bf16 and int8 rows)")
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = build.load("suffix_attention").ospo_suffix_attention
    err = fn(q.data_ptr(), k_cache[layer_idx].data_ptr(), v_cache[layer_idx].data_ptr(),
             ptr(k_scale[layer_idx]) if quantized else None,
             ptr(v_scale[layer_idx]) if quantized else None,
             mask.data_ptr(), ptr(pk), ptr(pv), ptr(pm), out.data_ptr(), B, T, H,
             cur_len, C, mask.shape[1], pm_ld, dh, _KV_DTYPES[k_cache.dtype], stream)
    build.check(err, "suffix_attention")
    count_launch("suffix_attention")
    return out
