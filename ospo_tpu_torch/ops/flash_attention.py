"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu``
and their plain PyTorch versions.

Counterpart of ``ospo_tpu/ops/flash_attention.py``.  Semantics, shared by
the kernels and the plain versions:

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

The backward recomputes the probabilities from ``m`` and ``l``
(``p = exp(s - m) / max(l, 1e-30)``, 0 for excluded keys, so the same rule
holds for pad rows) and takes ``di = rowsum(O * dO)`` from the caller, as the
TPU wrapper does (``_flash_bwd`` :294): ``dq = ds . K``, ``dk = ds^T . Q``,
``dv = p^T . dO`` with ``ds = p * (dp - di) * D^-0.5``, ``dp = dO . V^T``.
GQA gradients are summed over each key/value head's query heads in fp32 and
rounded once (the TPU wrapper rounds each head's gradient, then sums).
:func:`flash_attention_train` is the differentiable entry point.

The plain forward and backward keep p (and ds) in fp32, as the TPU kernels
do.  The bf16 bodies of the kernels take FlashAttention-2's scheme on the
tensor cores instead: they scale the scores after the product,
``(q . k) * D^-0.5``; the forward rounds ``p`` to bf16 before ``P . V``
(its m and l take the fp32 p), the backward rounds ``p`` (for dV) and
``ds`` (for dQ and dK) before the second products.  The forward is held to
the plain forward within ``1e-2 + 1e-2 |O|`` (l within 1e-5 relative, m
within 1e-4), the backward to the plain backward within
``2^-8 max|ref| + 2^-7 |ref|``, and each against a float64 reference to at
most twice the plain version's RMS error (``tests/flash_fwd_reference.py``,
``tests/flash_bwd_reference.py``).
"""

from __future__ import annotations

import torch

from ospo_tpu_torch.utils.profiling import count_launch

NEG_FILL = -1e30
HEAD_DIM = 128

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


def _check(what, q, k, v, mask, extra=()):
    """Device, dtype, shape and contiguity checks shared by the wrappers;
    returns the mask (all ones when None)."""
    B, T, H, D = q.shape
    S, kvh = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the "
                         f"kernel takes float32 or bfloat16")
    if D != HEAD_DIM or k.shape != (B, S, kvh, D) or v.shape != k.shape \
            or H % kvh:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}; the kernel "
                         f"takes head_dim {HEAD_DIM} and H divisible by KVH")
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.int32, device=q.device)
    if mask.dtype != torch.int32 or mask.shape != (B, S) \
            or mask.device != q.device:
        raise ValueError(f"{what}: mask must be int32 [B, S] on the device "
                         f"of q")
    for name, t, shape, dtype in extra:
        if t.device != q.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} {shape} on the "
                             f"device of q, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)) + tuple(
            (e[0], e[1]) for e in extra):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return mask


def flash_attention(q, k, v, mask=None, causal=True, return_stats=False):
    """Launch the forward kernel for CUDA tensors; the plain version for CPU
    tensors.  Returns O, or (O, l, m) with ``return_stats``."""
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, mask, causal)
        return out if return_stats else out[0]
    from ospo_tpu_torch.ops import build

    B, T, H, D = q.shape
    S, kvh = k.shape[1], k.shape[2]
    mask = _check("flash_attention", q, k, v, mask)
    out = torch.empty_like(q)
    l = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = build.load("flash_fwd").ospo_flash_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             out.data_ptr(), l.data_ptr(), m.data_ptr(),
             B, T, S, H, kvh, D, int(bool(causal)), _DTYPES[q.dtype], stream)
    build.check(err, "flash_fwd")
    count_launch("flash_fwd")
    return (out, l, m) if return_stats else out


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _bwd_terms(q, k, v, mask, do, m, l, di, causal):
    """fp32 (p, ds, k, q, dO) of the backward, GQA heads repeated."""
    B, T, H, D = q.shape
    S, kvh = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if kvh != H:
        kf = kf.repeat_interleave(H // kvh, dim=2)
        vf = vf.repeat_interleave(H // kvh, dim=2)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bthd,bshd->bhts", qf * D ** -0.5, kf)
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s,
                        torch.full_like(s, NEG_FILL))
    p = torch.exp(s - m[..., None]) / l.clamp_min(1e-30)[..., None]
    if causal:
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        p = p.masked_fill(cols > rows, 0.0)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - di[..., None]) * D ** -0.5
    return p, ds, kf, qf, dof


def flash_dq_plain(q, k, v, mask, do, m, l, di, causal=True):
    """Plain PyTorch version of the dQ kernel → dq [B,T,H,D] in q's dtype."""
    _, ds, kf, _, _ = _bwd_terms(q, k, v, mask, do, m, l, di, causal)
    return torch.einsum("bhts,bshd->bthd", ds, kf).to(q.dtype)


def flash_dkv_plain(q, k, v, mask, do, m, l, di, causal=True):
    """Plain PyTorch version of the dK/dV kernel → (dk, dv) [B,S,KVH,D] in
    k's dtype, summed over each key/value head's query heads in fp32."""
    B, T, H, D = q.shape
    S, kvh = k.shape[1], k.shape[2]
    p, ds, _, qf, dof = _bwd_terms(q, k, v, mask, do, m, l, di, causal)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    if kvh != H:
        dk = dk.reshape(B, S, kvh, H // kvh, D).sum(dim=3)
        dv = dv.reshape(B, S, kvh, H // kvh, D).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


def row_dot(o, do):
    """di = rowsum(O * dO) in fp32, [B, T, H, D] → [B, H, T]."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, mask, o, l, m, do, causal=True):
    """The whole plain backward from the forward's outputs → (dq, dk, dv)."""
    di = row_dot(o, do)
    dq = flash_dq_plain(q, k, v, mask, do, m, l, di, causal)
    return (dq, *flash_dkv_plain(q, k, v, mask, do, m, l, di, causal))


def _stats_extra(q, do, m, l, di):
    B, T, H, _ = q.shape
    return (("dO", do, tuple(q.shape), q.dtype),
            ("m", m, (B, H, T), torch.float32),
            ("l", l, (B, H, T), torch.float32),
            ("di", di, (B, H, T), torch.float32))


def flash_dq(q, k, v, mask, do, m, l, di, causal=True):
    """Launch the dQ kernel for CUDA tensors; the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, mask, do, m, l, di, causal)
    from ospo_tpu_torch.ops import build

    B, T, H, D = q.shape
    S, kvh = k.shape[1], k.shape[2]
    mask = _check("flash_dq", q, k, v, mask, _stats_extra(q, do, m, l, di))
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = build.load("flash_bwd_dq").ospo_flash_bwd_dq
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             do.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(),
             dq.data_ptr(), B, T, S, H, kvh, D, int(bool(causal)),
             _DTYPES[q.dtype], stream)
    build.check(err, "flash_bwd_dq")
    count_launch("flash_bwd_dq")
    return dq


def flash_dkv(q, k, v, mask, do, m, l, di, causal=True):
    """Launch the dK/dV kernel for CUDA tensors; the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, mask, do, m, l, di, causal)
    from ospo_tpu_torch.ops import build

    B, T, H, D = q.shape
    S, kvh = k.shape[1], k.shape[2]
    mask = _check("flash_dkv", q, k, v, mask, _stats_extra(q, do, m, l, di))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = build.load("flash_bwd_dkv").ospo_flash_bwd_dkv
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             do.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, T, S, H, kvh, D,
             int(bool(causal)), _DTYPES[q.dtype], stream)
    build.check(err, "flash_bwd_dkv")
    count_launch("flash_bwd_dkv")
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, then dQ and dK/dV kernels in the backward — the
    counterpart of the JAX package's ``jax.custom_vjp`` (``_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, l, m = flash_attention(q, k, v, mask, causal, return_stats=True)
        ctx.save_for_backward(q, k, v, mask, out, l, m)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, l, m = ctx.saved_tensors
        g = g.contiguous()
        di = row_dot(out, g)
        dq = flash_dq(q, k, v, mask, g, m, l, di, ctx.causal)
        dk, dv = flash_dkv(q, k, v, mask, g, m, l, di, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, mask=None, causal=True):
    """Differentiable flash attention: O [B,T,H,D], gradients through the
    dQ and dK/dV kernels (their plain versions for CPU tensors)."""
    return _FlashAttention.apply(q, k, v, mask, causal)
