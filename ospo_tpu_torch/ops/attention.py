"""Attention dispatch: the flash kernels for self-attention, the plain masked
attention :func:`xla_attention` elsewhere (counterpart of
``ospo_tpu/ops/attention.py``).

Shared semantics:
  q: [B, T, H, Dh] — new queries, absolute rows [q_offset, q_offset + T)
  k, v: [B, S, KVH, Dh] — the key/value window
  mask: [B, S] validity of each key row
  causal: query row i may attend key row j iff j <= q_offset + i.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_FILL = -1e30


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], q_offset: int = 0,
                  causal: bool = True) -> torch.Tensor:
    """Plain masked attention, fp32 softmax, ``-1e30`` fill for every
    disallowed key (a fully masked row averages V over all S keys) — the
    counterpart of the JAX package's ``xla_attention`` for plain ``bshd``
    arrays."""
    B, T, H, Dh = q.shape
    S, kvh = k.shape[1], k.shape[2]
    if kvh != H:
        k = k.repeat_interleave(H // kvh, dim=2)
        v = v.repeat_interleave(H // kvh, dim=2)
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


def attention(q, k, v, mask=None, q_offset: int = 0, causal: bool = True,
              impl: str = "auto") -> torch.Tensor:
    """``impl`` as in ``ospo_tpu.ops.attention.attention`` (:263-313):

    - ``"auto"``: self-attention (``q_offset == 0`` and T == S) takes the
      flash path, any other shape :func:`xla_attention`;
    - ``"flash"``: the flash path; only a ``q_offset`` of 0 (the kernels'
      causality is row-local);
    - ``"xla"``: :func:`xla_attention`, differentiated by autograd.

    The flash path is differentiable: the forward kernel, and the dQ and
    dK/dV kernels in the backward (the plain versions for CPU tensors).
    """
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown attention impl {impl!r} "
                         "(expected auto | flash | xla)")
    offset_zero = isinstance(q_offset, int) and q_offset == 0
    if impl == "flash" and not offset_zero:
        raise ValueError(
            "impl='flash' supports only a static q_offset of 0 (prefill); "
            "cached/offset reads take the XLA path")
    if impl == "xla" or (impl == "auto" and (
            not offset_zero or q.shape[1] != k.shape[1])):
        return xla_attention(q, k, v, mask, q_offset, causal)
    from ospo_tpu_torch.ops.flash_attention import flash_attention_train

    return flash_attention_train(q, k, v, mask=mask, causal=causal)
