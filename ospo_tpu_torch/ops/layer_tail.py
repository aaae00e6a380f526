"""The elementwise chain between a LLaMA layer's products: the plain op
chains (``rms_norm``, ``apply_rope``, ``quantize_rows``) and, for a cached
step on the card, three hand-written CUDA kernels (``csrc/layer_tail.cu``)
in place of the chain's one PyTorch kernel an op.

- :func:`add_rms_norm`: ``x + y`` (bf16 of the fp32 sum) and RMSNorm of the
  sum times the weight; ``y`` None norms ``x`` alone;
- :func:`rope_kv_write`: rope on q and k, and k and v written into one
  layer of an ``shbd`` cache at the step's position (int8 rows with fp32
  scales, or bf16 rows);
- :func:`silu_mul`: ``silu(gate) · up``.

Each has a plain version composed of the plain chains, which the CPU takes;
on the card a wrapper launches its kernel or raises.  The kernels keep the
plain chain's roundings step by step (``csrc/layer_tail.cu``); only the
order of the norm's fp32 sum of squares differs, so rope, the cache rows,
their scales and SiLU·up are bit-equal to the plain chain and the norm is
within its ties.  :func:`takes` says whether a cached step of
``models/llama.py::forward`` runs them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ospo_tpu_torch.utils.profiling import count_launch

HEAD_DIM = 128        # the rope kernel's head dim
NORM_MAX_WIDTH = 8192  # the norm kernel's widest row
VEC = 8               # bf16 values of a 16-byte load: widths are multiples


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics; the normalised value is cast to x's dtype BEFORE the
    weight multiply (``llama.py:129-132``)."""
    xf = x.float()
    rms = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return ((xf * rms).to(x.dtype) * weight).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF-Llama rotate-half convention in fp32. x: [B, T, H, Dh]."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def quantize_rows(x: torch.Tensor):
    """[..., Dh] → (int8 values, fp32 scales [...]) per row (``llama.py:289``)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def takes(x: torch.Tensor, kv_cache: dict, head_dim: int, ffn: int) -> bool:
    """Whether a cached step whose caller has an ``shbd`` MHA cache without
    int4 payload or per-row offsets runs the kernels: bf16 activations on
    the card, head dim 128, widths that are whole 16-byte loads (the norm's
    at most 8192), and a bf16 cache or an int8 one with scales."""
    k = kv_cache["k"]
    d = x.shape[-1]
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and head_dim == HEAD_DIM and d % VEC == 0 and d <= NORM_MAX_WIDTH
            and ffn % VEC == 0
            and (k.dtype == torch.bfloat16
                 or (k.dtype == torch.int8 and "k_s" in kv_cache)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def add_rms_norm_plain(x: torch.Tensor, y: Optional[torch.Tensor],
                       weight: torch.Tensor, eps: float):
    """→ (``x + y``, ``rms_norm(x + y)``); ``y`` None: (``x``, ``rms_norm(x)``)."""
    if y is not None:
        x = x + y
    return x, rms_norm(x, weight, eps)


def rope_kv_write_plain(q, k, v, cos, sin, cache: dict, li: int, pos,
                        roped_k: bool = False):
    """Rope on q and k ``[B, T, H, Dh]``; k (roped) and v written into layer
    ``li`` of the ``shbd`` cache at positions ``[pos, pos + T)``, quantized
    row by row where the cache has scales → (roped q, roped k if
    ``roped_k`` else None).  ``pos`` is a host integer, or an int64 tensor
    ``[1]`` in device memory for T = 1."""
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    for name, x in (("k", k), ("v", v)):
        if "k_s" in cache:
            xq, xs = quantize_rows(x)
            rows = ((name, xq.permute(1, 2, 0, 3)), (name + "_s", xs.permute(1, 2, 0)))
        else:
            rows = ((name, x.permute(1, 2, 0, 3).to(cache[name].dtype)),)
        for key, val in rows:
            if isinstance(pos, torch.Tensor):
                cache[key][li].index_copy_(0, pos, val)
            else:
                cache[key][li, pos:pos + val.shape[0]] = val
    return q, (k if roped_k else None)


def silu_mul_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate)`` in fp32, cast to gate's dtype, times ``up``."""
    return F.silu(gate.float()).to(gate.dtype) * up


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _refuse(what: str, *tensors, dtype=torch.bfloat16) -> None:
    for t in tensors:
        if t.device != tensors[0].device or t.dtype != dtype:
            raise ValueError(f"{what}: takes {dtype} tensors on one CUDA device, "
                             f"got {[(x.dtype, str(x.device)) for x in tensors]}")


def add_rms_norm(x: torch.Tensor, y: Optional[torch.Tensor], weight: torch.Tensor,
                 eps: float):
    """:func:`add_rms_norm_plain` of x (and y) ``[..., D]``: the plain
    version on the CPU, the ``add_rms_norm`` kernel on the card (bf16, D a
    multiple of 8 and at most 8192, weight ``[D]``)."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, y, weight, eps)
    from ospo_tpu_torch.ops import build

    d = x.shape[-1]
    _refuse("add_rms_norm", x, weight, *(() if y is None else (y,)))
    if d % VEC or d > NORM_MAX_WIDTH or weight.shape != (d,) \
            or (y is not None and y.shape != x.shape):
        raise ValueError(f"add_rms_norm: x {tuple(x.shape)}, y "
                         f"{None if y is None else tuple(y.shape)}, weight "
                         f"{tuple(weight.shape)}; the kernel takes rows of a width "
                         f"that is a multiple of {VEC}, at most {NORM_MAX_WIDTH}")
    x = x.contiguous()
    y = None if y is None else y.contiguous()
    weight = weight.contiguous()
    if any(t.data_ptr() % 16 for t in (x, weight, *(() if y is None else (y,)))):
        raise ValueError("add_rms_norm: x, y and the weight must be 16-byte aligned")
    h = torch.empty_like(x)
    out = x if y is None else torch.empty_like(x)
    build.check(build.load("layer_tail").ospo_add_rms_norm(
        x.data_ptr(), None if y is None else y.data_ptr(), weight.data_ptr(),
        None if y is None else out.data_ptr(), h.data_ptr(), x.numel() // d, d,
        float(eps), _stream(x)), "add_rms_norm")
    count_launch("add_rms_norm")
    return out, h


def rope_kv_write(q, k, v, cos, sin, cache: dict, li: int, pos,
                  roped_k: bool = False):
    """:func:`rope_kv_write_plain`: the plain version on the CPU, the
    ``rope_kv_write`` kernel on the card.  The kernel takes bf16 q, k and v
    ``[B, T, H, 128]`` with any strides but a unit one along the head (the
    fused projection's views as they are), fp32 cos and sin ``[B, T, 64]``,
    and a contiguous ``shbd`` cache ``[L, S, H, B, 128]`` of bf16 rows, or
    of int8 rows with fp32 scales ``[L, S, H, B]``; the kernel reads a
    device position when it runs."""
    if q.device.type == "cpu":
        return rope_kv_write_plain(q, k, v, cos, sin, cache, li, pos, roped_k)
    from ospo_tpu_torch.ops import build

    B, T, H, D = q.shape
    kc, vc, ks, vs = cache["k"], cache["v"], cache.get("k_s"), cache.get("v_s")
    L, S = kc.shape[:2]
    _refuse("rope_kv_write", q, k, v)
    if D != HEAD_DIM or k.shape != q.shape or v.shape != q.shape \
            or kc.shape != (L, S, H, B, D) or vc.shape != kc.shape:
        raise ValueError(f"rope_kv_write: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, cache {tuple(kc.shape)}; the kernel takes "
                         f"MHA heads of {HEAD_DIM} and an shbd cache [L, S, H, B, Dh]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 2 for s in t.stride()[:3]) or t.data_ptr() % 4:
            raise ValueError(f"rope_kv_write: {name} needs a unit stride along the "
                             "head and 4-byte aligned rows")
    cos, sin = cos.contiguous(), sin.contiguous()
    _refuse("rope_kv_write", cos, sin, dtype=torch.float32)
    if cos.shape != (B, T, D // 2) or sin.shape != cos.shape:
        raise ValueError(f"rope_kv_write: cos/sin {tuple(cos.shape)}, expected "
                         f"{(B, T, D // 2)}")
    quantized = ks is not None
    if not kc.is_contiguous() or not vc.is_contiguous() or kc.dtype != vc.dtype \
            or kc.dtype != (torch.int8 if quantized else torch.bfloat16) \
            or (quantized and not all(
                s is not None and s.dtype == torch.float32 and s.is_contiguous()
                and s.shape == (L, S, H, B) for s in (ks, vs))):
        raise ValueError("rope_kv_write: the cache must be contiguous bf16 rows, or "
                         "int8 rows with contiguous fp32 scales [L, S, H, B]")
    if not 0 <= li < L:
        raise ValueError(f"rope_kv_write: layer {li} of {L}")
    if isinstance(pos, torch.Tensor):
        if pos.device != q.device or pos.dtype != torch.int64 or pos.numel() != 1 \
                or T != 1:
            raise ValueError("rope_kv_write: a device position is one int64 on q's "
                             "device, for T = 1")
        pos_ptr, pos = pos.data_ptr(), 0
    else:
        pos_ptr, pos = None, int(pos)
        if not 0 <= pos <= S - T:
            raise ValueError(f"rope_kv_write: positions [{pos}, {pos + T}) of {S}")
    q_out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    k_out = torch.empty_like(q_out) if roped_k else None
    ptr = lambda t: None if t is None else t[li].data_ptr()  # noqa: E731
    build.check(build.load("layer_tail").ospo_rope_kv_write(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        q_out.data_ptr(), None if k_out is None else k_out.data_ptr(),
        ptr(kc), ptr(vc), ptr(ks), ptr(vs), pos_ptr, pos, B, T, H, S,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], _stream(q)), "rope_kv_write")
    count_launch("rope_kv_write")
    return q_out, k_out


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """:func:`silu_mul_plain`: the plain version on the CPU, the
    ``silu_mul`` kernel on the card (bf16, a multiple of 8 values)."""
    if gate.device.type == "cpu":
        return silu_mul_plain(gate, up)
    from ospo_tpu_torch.ops import build

    _refuse("silu_mul", gate, up)
    if up.shape != gate.shape or gate.numel() % VEC or gate.numel() >= 2 ** 31:
        raise ValueError(f"silu_mul: gate {tuple(gate.shape)}, up {tuple(up.shape)}; "
                         f"the kernel takes equal shapes of a multiple of {VEC} values")
    gate, up = gate.contiguous(), up.contiguous()
    if gate.data_ptr() % 16 or up.data_ptr() % 16:
        raise ValueError("silu_mul: gate and up must be 16-byte aligned")
    out = torch.empty_like(gate)
    build.check(build.load("layer_tail").ospo_silu_mul(
        gate.data_ptr(), up.data_ptr(), out.data_ptr(), gate.numel(), _stream(gate)),
        "silu_mul")
    count_launch("silu_mul")
    return out
