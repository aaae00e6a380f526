"""Attention dispatch: the flash kernels for self-attention, the plain masked
attention :func:`xla_attention` elsewhere (counterpart of
``ospo_tpu/ops/attention.py``).

Shared semantics:
  q: [B, T, H, Dh] — new queries, absolute rows [q_offset, q_offset + T)
  k, v: [B, S, KVH, Dh] — the key/value window
  mask: [B, S] validity of each key row
  causal: query row i may attend key row j iff j <= q_offset + i.

A batch-shared prefix segment (the text engine's shared-prefix decode,
``ospo_tpu/ops/attention.py:142-170``): ``prefix_k`` / ``prefix_v``
``[C, KVH, Dh]``, stored once for the batch and never copied per row, with
``prefix_mask`` ``[C]``, ``[1, C]`` or ``[B, C]``, precedes every own key (no
causal test inside it).  Its scores join the own scores in ONE fp32 softmax
over ``[prefix ++ own]``, so the result is that of the prefix materialised
per row.  The XLA path of the JAX package is its counterpart, so these forms
are plain PyTorch: :func:`xla_attention` over a fresh chunk (the tail
prefill) or over a cache window (a cached T > 1 step, with or without the
prefix: step 4b's question suffixes), and :func:`prefix_decode_attention`
over the batch-minor cache (a cached T = 1 step).

:func:`xla_attention` also reads a cache window in any of the three layouts
(``kv_layout`` ``bshd`` ``[B, S, H, Dh]``, ``bhsd`` ``[B, H, S, Dh]``,
``shbd`` ``[S, H, B, Dh]``) with a model-dtype, int8 ``{"q", "s"}`` or int4
head-pair ``{"q4", "s"}`` payload (scales ``[B, H, S]``) and a shared or
per-row (``[B]``) query offset (``ospo_tpu/ops/attention.py:50-186``): the
scales fold into the scores and probabilities and the nibbles unpack inside
the reads, so no dequantized copy of the cache is made.
"""

from __future__ import annotations

from typing import Optional

import torch

from ospo_tpu_torch.ops.quant import unpack_int4_halves

NEG_FILL = -1e30
# fp32 score elements [rows, H, T, C + S] the prefix form of xla_attention
# holds at once; the batch is cut into row chunks under it
PREFIX_SCORE_ELEMS = 1 << 27


def _prefix_allowed(prefix_mask: Optional[torch.Tensor], C: int,
                    device) -> torch.Tensor:
    """Prefix key validity as [1 | B, C] bool."""
    if prefix_mask is None:
        return torch.ones((1, C), dtype=torch.bool, device=device)
    pm = prefix_mask != 0
    return pm[None] if pm.ndim == 1 else pm


def _repeat_heads(x: torch.Tensor, H: int, dim: int) -> torch.Tensor:
    return x if x.shape[dim] == H else x.repeat_interleave(H // x.shape[dim], dim=dim)


# axes of a layer's cache window in each layout
POS_AXIS = {"bshd": 1, "bhsd": 2, "shbd": 0}
HEAD_AXIS = {"bshd": 2, "bhsd": 1, "shbd": 1}
BATCH_AXIS = {"bshd": 0, "bhsd": 0, "shbd": 2}
TO_BHSD = {"bshd": (0, 2, 1, 3), "bhsd": (0, 1, 2, 3), "shbd": (2, 1, 0, 3)}


# head-pair packed int8 → (low, high) nibble halves, the inverse of
# ``llama._quantize_rows_int4`` (head j in the low nibble of head slot j,
# head j + H/2 in the high one): the weights' unpack, the same bits
unpack_int4 = unpack_int4_halves


def xla_attention(q: torch.Tensor, k, v, mask: Optional[torch.Tensor],
                  q_offset=0, causal: bool = True,
                  prefix_k: Optional[torch.Tensor] = None,
                  prefix_v: Optional[torch.Tensor] = None,
                  prefix_mask: Optional[torch.Tensor] = None,
                  kv_layout: str = "bshd") -> torch.Tensor:
    """Plain masked attention, fp32 softmax, ``-1e30`` fill for every
    disallowed key (a fully masked row averages V over all S keys) — the
    counterpart of the JAX package's ``xla_attention``, with the
    batch-shared prefix segment when ``prefix_k`` is given.  Plain ``bshd``
    tensors with a shared offset take the form below; a quantized payload,
    another layout or a per-row ``q_offset`` ``[B]`` take
    :func:`_layout_attention`."""
    if isinstance(k, dict) or kv_layout != "bshd" or torch.is_tensor(q_offset):
        return _layout_attention(q, k, v, mask, q_offset, causal, kv_layout,
                                 prefix_k, prefix_v, prefix_mask)
    B, T, H, Dh = q.shape
    S = k.shape[1]
    k, v = _repeat_heads(k, H, 2), _repeat_heads(v, H, 2)
    if prefix_k is not None:
        return _prefix_chunk_attention(q, k, v, mask, q_offset, causal,
                                       _repeat_heads(prefix_k, H, 1),
                                       _repeat_heads(prefix_v, H, 1),
                                       prefix_mask)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * Dh ** -0.5
    allowed = torch.ones((B, 1, T, S), dtype=torch.bool, device=q.device)
    if mask is not None:
        allowed = allowed & (mask[:, None, None, :] != 0)
    if causal:
        rows = q_offset + torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        allowed = allowed & (cols <= rows)
    scores = torch.where(allowed, scores, torch.full_like(scores, NEG_FILL))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return out.to(q.dtype)


def _bhsd_f32(x: torch.Tensor, layout: str) -> torch.Tensor:
    """A window's chunk in ``layout`` → contiguous fp32 ``[B, H, S, Dh]``,
    converted and reordered in one copy."""
    x = x.permute(TO_BHSD[layout]) if layout != "bhsd" else x
    return x.to(torch.float32, memory_format=torch.contiguous_format)


def _layout_attention(q, k, v, mask, q_offset, causal, kv_layout, prefix_k,
                      prefix_v, prefix_mask):
    """:func:`xla_attention` over a cache window (``ospo_tpu/ops/attention.py
    :84-186``): k / v plain tensors or ``{"q", "s"}`` / ``{"q4", "s"}`` dicts
    in ``kv_layout``, scales ``[B, KVH | H, S]``; ``q_offset`` an int or a
    per-row ``[B]`` tensor.  Scores ``(q . k) * Dh^-0.5`` in fp32 with the k
    scale folded in; the v scale folds into the probabilities; an int4
    payload scores heads ``[0, H/2)`` against its low nibbles and
    ``[H/2, H)`` against its high ones.  Each chunk of batch rows (their
    scores under ``PREFIX_SCORE_ELEMS``) converts its keys and values to
    fp32 ``[b, H, S, Dh]`` once, for batched products."""
    B, T, H, Dh = q.shape
    int4 = isinstance(k, dict) and "q4" in k
    if isinstance(k, dict):
        kq, ks = k["q4" if int4 else "q"], k["s"]
        vq, vs = v["q4" if int4 else "q"], v["s"]
    else:
        kq, ks, vq, vs = k, None, v, None
    hax, bax = HEAD_AXIS[kv_layout], BATCH_AXIS[kv_layout]
    S = kq.shape[POS_AXIS[kv_layout]]
    if int4:
        if kq.shape[hax] * 2 != H:
            raise ValueError("int4 KV is MHA-only (head-pair packed: cache "
                             "head axis H/2)")
    else:
        kq, vq = _repeat_heads(kq, H, hax), _repeat_heads(vq, H, hax)
    if ks is not None:
        ks, vs = _repeat_heads(ks, H, 1), _repeat_heads(vs, H, 1)
    C = 0 if prefix_k is None else prefix_k.shape[0]
    if C:
        pkf = _repeat_heads(prefix_k, H, 1).float()
        pvf = _repeat_heads(prefix_v, H, 1).float()
        p_ok = _prefix_allowed(prefix_mask, C, q.device)         # [1|B, C]
    per_row = torch.is_tensor(q_offset)
    scale = Dh ** -0.5
    cols = torch.arange(S, device=q.device)
    step = max(1, PREFIX_SCORE_ELEMS // (H * T * (C + S)))
    outs = []
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        qf = q[b0:b1].float().transpose(1, 2)                    # [b, H, T, Dh]
        kc = kq.narrow(bax, b0, b1 - b0)
        vc = vq.narrow(bax, b0, b1 - b0)
        if int4:
            h2 = H // 2
            k_lo, k_hi = (_bhsd_f32(x, kv_layout) for x in unpack_int4(kc))
            s_own = torch.cat([qf[:, :h2] @ k_lo.transpose(-1, -2),
                               qf[:, h2:] @ k_hi.transpose(-1, -2)], dim=1)
        else:
            s_own = qf @ _bhsd_f32(kc, kv_layout).transpose(-1, -2)
        s_own = s_own * scale                                    # [b, H, T, S]
        if ks is not None:
            s_own = s_own * ks[b0:b1, :, None, :]
        ok = torch.ones((b1 - b0, 1, T, S), dtype=torch.bool, device=q.device)
        if mask is not None:
            ok = ok & (mask[b0:b1, None, None, :] != 0)
        if causal:
            if per_row:
                rows = q_offset[b0:b1, None, None] + torch.arange(
                    T, device=q.device)[None, :, None]           # [b, T, 1]
            else:
                rows = q_offset + torch.arange(T, device=q.device)[None, :, None]
            ok = ok & (cols[None, None, :] <= rows)[:, None]
        s_own = torch.where(ok, s_own, torch.full_like(s_own, NEG_FILL))
        if C:
            s_pre = torch.einsum("bhtd,chd->bhtc", qf, pkf) * scale
            pm = p_ok if p_ok.shape[0] == 1 else p_ok[b0:b1]
            s_pre = torch.where(pm[:, None, None, :], s_pre,
                                torch.full_like(s_pre, NEG_FILL))
            probs = torch.softmax(torch.cat([s_pre, s_own], dim=-1), dim=-1)
            p_own = probs[..., C:]
        else:
            p_own = torch.softmax(s_own, dim=-1)
        if vs is not None:
            p_own = p_own * vs[b0:b1, :, None, :]
        if int4:
            v_lo, v_hi = (_bhsd_f32(x, kv_layout) for x in unpack_int4(vc))
            out = torch.cat([p_own[:, :h2] @ v_lo, p_own[:, h2:] @ v_hi], dim=1)
        else:
            out = p_own @ _bhsd_f32(vc, kv_layout)               # [b, H, T, Dh]
        if C:
            out = out + torch.einsum("bhtc,chd->bhtd", probs[..., :C], pvf)
        outs.append(out.transpose(1, 2))
    return torch.cat(outs).to(q.dtype)


def _prefix_chunk_attention(q, k, v, mask, q_offset, causal, pk, pv,
                            prefix_mask):
    """The prefix form of :func:`xla_attention` (heads already repeated),
    over row chunks whose scores stay under ``PREFIX_SCORE_ELEMS``; rows
    are independent, so the chunks change nothing but the memory held."""
    B, T, H, Dh = q.shape
    S, C = k.shape[1], pk.shape[0]
    scale = Dh ** -0.5
    p_ok = _prefix_allowed(prefix_mask, C, q.device)             # [1|B, C]
    rows = torch.arange(T, device=q.device)[:, None] + q_offset
    causal_ok = (torch.arange(S, device=q.device)[None, :] <= rows) if causal \
        else torch.ones((T, S), dtype=torch.bool, device=q.device)
    pkf, pvf = pk.float(), pv.float()
    step = max(1, PREFIX_SCORE_ELEMS // (H * T * (C + S)))
    outs = []
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        qf = q[b0:b1].float()
        s_own = torch.einsum("bthd,bshd->bhts", qf, k[b0:b1].float()) * scale
        ok = causal_ok[None, None]
        if mask is not None:
            ok = ok & (mask[b0:b1, None, None, :] != 0)
        s_own = torch.where(ok, s_own, torch.full_like(s_own, NEG_FILL))
        s_pre = torch.einsum("bthd,chd->bhtc", qf, pkf) * scale
        pm = p_ok if p_ok.shape[0] == 1 else p_ok[b0:b1]
        s_pre = torch.where(pm[:, None, None, :], s_pre,
                            torch.full_like(s_pre, NEG_FILL))
        probs = torch.softmax(torch.cat([s_pre, s_own], dim=-1), dim=-1)
        outs.append(torch.einsum("bhtc,chd->bthd", probs[..., :C], pvf)
                    + torch.einsum("bhts,bshd->bthd", probs[..., C:],
                                   v[b0:b1].float()))
    return torch.cat(outs).to(q.dtype)


def prefix_decode_attention(q, k_cache, v_cache, layer_idx: int, cur_len: int,
                            mask, prefix_k, prefix_v, prefix_mask=None,
                            k_scale=None, v_scale=None) -> torch.Tensor:
    """A cached T = 1 step with the batch-shared prefix: q ``[B, 1, H, Dh]``
    against ``prefix_k`` / ``prefix_v`` ``[C, H, Dh]`` and rows
    ``[0, cur_len)`` of layer ``layer_idx`` of the batch-minor cache
    ``[L, S, H, B, Dh]`` (bf16 or f32, or int8 with ``[L, S, H, B]`` fp32
    scales), ``mask`` ``[B, S]`` covering the cache window.  As the
    reference's read of the whole window (:127, :171): scores
    ``(q . k) * Dh^-0.5``, the k scale folded into the own scores, one
    softmax over ``[prefix ++ own]``, the v scale folded into the own
    probabilities.  Unwritten rows past ``cur_len`` are masked there and add
    exactly 0, so only the populated rows are read.  MHA only.  → [B, 1, H,
    Dh] in q's dtype.

    The cache slice is read in place: each (head, row) pair is one matrix
    of a strided batched product, so the cache's ``[S, H, B]`` order needs
    no transposed copy (only the fp32 conversion of the slice)."""
    B, _, H, Dh = q.shape
    C = prefix_k.shape[0]
    scale = Dh ** -0.5
    qf = q[:, 0].float().permute(1, 0, 2)                        # [H, B, Dh]
    # prefix: [H, B, Dh] x [H, Dh, C] (a strided view of [C, H, Dh])
    s_pre = torch.bmm(qf, prefix_k.float().permute(1, 2, 0)) * scale
    s_pre = torch.where(_prefix_allowed(prefix_mask, C, q.device)[None],
                        s_pre, torch.full_like(s_pre, NEG_FILL))
    # own rows: batch (h, b) of [cur, Dh] matrices with row stride H*B*Dh
    kf = k_cache[layer_idx, :cur_len].float().view(cur_len, H * B, Dh)
    s_own = torch.bmm(kf.transpose(0, 1), qf.reshape(H * B, Dh, 1))
    s_own = s_own.view(H, B, cur_len) * scale
    if k_scale is not None:
        s_own = s_own * k_scale[layer_idx, :cur_len].permute(1, 2, 0)
    s_own = torch.where(mask[None, :, :cur_len] != 0, s_own,
                        torch.full_like(s_own, NEG_FILL))
    probs = torch.softmax(torch.cat([s_pre, s_own], dim=-1), dim=-1)
    p_own = probs[..., C:]
    if v_scale is not None:
        p_own = p_own * v_scale[layer_idx, :cur_len].permute(1, 2, 0)
    out = torch.bmm(probs[..., :C], prefix_v.float().permute(1, 0, 2))
    vf = v_cache[layer_idx, :cur_len].float().view(cur_len, H * B, Dh)
    out = out + torch.bmm(p_own.reshape(H * B, 1, cur_len),
                          vf.transpose(0, 1)).view(H, B, Dh)
    return out.permute(1, 0, 2)[:, None].to(q.dtype)


def attention(q, k, v, mask=None, q_offset: int = 0, causal: bool = True,
              impl: str = "auto", prefix_k=None, prefix_v=None,
              prefix_mask=None) -> torch.Tensor:
    """``impl`` as in ``ospo_tpu.ops.attention.attention`` (:263-313):

    - ``"auto"``: the flash path where the JAX dispatcher takes it (static
      offset 0, T == S, T > 1, a head dim that is a multiple of 128),
      narrowed to the kernel's one head dim, 128 (SigLIP-L's 64 takes the
      plain form, as on the TPU); any other call :func:`xla_attention`;
    - ``"flash"``: the flash path; only a ``q_offset`` of 0 (the kernels'
      causality is row-local), and off the CPU (where the plain versions
      take any head dim) only head dim 128;
    - ``"xla"``: :func:`xla_attention`, differentiated by autograd.

    The flash path is differentiable: the forward kernel, and the dQ and
    dK/dV kernels in the backward (the plain versions for CPU tensors).  A
    call with a batch-shared prefix (``prefix_k``) always takes
    :func:`xla_attention`: the kernel has no second key segment.
    """
    from ospo_tpu_torch.ops.flash_attention import HEAD_DIM

    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown attention impl {impl!r} "
                         "(expected auto | flash | xla)")
    offset_zero = isinstance(q_offset, int) and q_offset == 0
    if impl == "flash" and not offset_zero:
        raise ValueError(
            "impl='flash' supports only a static q_offset of 0 (prefill); "
            "cached/offset reads take the XLA path")
    if impl == "flash" and q.device.type != "cpu" and q.shape[-1] != HEAD_DIM:
        raise ValueError(
            f"impl='flash': head dim {q.shape[-1]}; the flash kernels take "
            f"head dim {HEAD_DIM} (use impl='auto' or 'xla')")
    flash_shape = (offset_zero and q.shape[1] > 1 and q.shape[1] == k.shape[1]
                   and q.shape[-1] == HEAD_DIM)
    if impl == "xla" or prefix_k is not None or (impl == "auto"
                                                 and not flash_shape):
        return xla_attention(q, k, v, mask, q_offset, causal,
                             prefix_k, prefix_v, prefix_mask)
    from ospo_tpu_torch.ops.flash_attention import flash_attention_train

    return flash_attention_train(q, k, v, mask=mask, causal=causal)
