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
prefill), :func:`prefix_decode_attention` over the batch-minor cache (a
cached T = 1 step) and :func:`cached_attention` (a cached T > 1 step, with
or without the prefix: step 4b's question suffixes).
"""

from __future__ import annotations

from typing import Optional

import torch

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


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], q_offset: int = 0,
                  causal: bool = True,
                  prefix_k: Optional[torch.Tensor] = None,
                  prefix_v: Optional[torch.Tensor] = None,
                  prefix_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain masked attention, fp32 softmax, ``-1e30`` fill for every
    disallowed key (a fully masked row averages V over all S keys) — the
    counterpart of the JAX package's ``xla_attention`` for plain ``bshd``
    arrays, with the batch-shared prefix segment when ``prefix_k`` is
    given."""
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


def cached_attention(q, k_cache, v_cache, layer_idx: int, cache_len: int,
                     mask, prefix_k=None, prefix_v=None, prefix_mask=None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """A cached multi-token step: q ``[B, T, H, Dh]`` for absolute rows
    ``[cache_len, cache_len + T)``, already written to layer ``layer_idx``
    of the batch-minor cache ``[L, S, H, B, Dh]`` (bf16 or f32, or int8 with
    ``[L, S, H, B]`` fp32 scales), against rows ``[0, cache_len + T)``:
    key j is allowed iff ``mask[b, j]`` and ``j <= cache_len + i``; ``mask``
    ``[B, S]`` covers the cache window.  With ``prefix_k`` / ``prefix_v``
    ``[C, KVH, Dh]`` the batch-shared prefix joins the same fp32 softmax.
    The reference's XLA path over the ``shbd`` cache
    (``ospo_tpu/ops/attention.py:50-185``): scores ``(q . k) * Dh^-0.5``,
    the k scale folded into the own scores, the v scale into the own
    probabilities; rows past ``cache_len + T`` are causally excluded
    there, so they are not read here.  The generalisation of
    :func:`prefix_decode_attention` to T > 1, in row chunks whose scores
    stay under ``PREFIX_SCORE_ELEMS``.  → ``[B, T, H, Dh]`` in q's dtype."""
    B, T, H, Dh = q.shape
    cur = cache_len + T
    C = 0 if prefix_k is None else prefix_k.shape[0]
    scale = Dh ** -0.5
    rows = cache_len + torch.arange(T, device=q.device)[:, None]
    causal_ok = torch.arange(cur, device=q.device)[None, :] <= rows  # [T, cur]
    if C:
        pkf = _repeat_heads(prefix_k, H, 1).float()
        pvf = _repeat_heads(prefix_v, H, 1).float()
        p_ok = _prefix_allowed(prefix_mask, C, q.device)         # [1|B, C]
    step = max(1, PREFIX_SCORE_ELEMS // (H * T * (C + cur)))
    outs = []
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        qf = q[b0:b1].float()
        kf = _repeat_heads(k_cache[layer_idx, :cur, :, b0:b1], H, 1).float()
        s_own = torch.einsum("bthd,shbd->bhts", qf, kf) * scale
        if k_scale is not None:
            ks = _repeat_heads(k_scale[layer_idx, :cur, :, b0:b1], H, 1)
            s_own = s_own * ks.permute(2, 1, 0)[:, :, None, :]
        ok = causal_ok[None, None] & (mask[b0:b1, None, None, :cur] != 0)
        s_own = torch.where(ok, s_own, torch.full_like(s_own, NEG_FILL))
        if C:
            s_pre = torch.einsum("bthd,chd->bhtc", qf, pkf) * scale
            pm = p_ok if p_ok.shape[0] == 1 else p_ok[b0:b1]
            s_pre = torch.where(pm[:, None, None, :], s_pre,
                                torch.full_like(s_pre, NEG_FILL))
            probs = torch.softmax(torch.cat([s_pre, s_own], dim=-1), dim=-1)
            p_own = probs[..., C:]
        else:
            p_own = torch.softmax(s_own, dim=-1)
        if v_scale is not None:
            vs = _repeat_heads(v_scale[layer_idx, :cur, :, b0:b1], H, 1)
            p_own = p_own * vs.permute(2, 1, 0)[:, :, None, :]
        vf = _repeat_heads(v_cache[layer_idx, :cur, :, b0:b1], H, 1).float()
        out = torch.einsum("bhts,shbd->bthd", p_own, vf)
        if C:
            out = out + torch.einsum("bhtc,chd->bthd", probs[..., :C], pvf)
        outs.append(out)
    return torch.cat(outs).to(q.dtype)


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
