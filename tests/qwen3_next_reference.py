"""Qwen3-Next trunk (Gated DeltaNet beside gated full attention, routed
experts with a gated shared expert) in plain PyTorch, float32, TF32 off:
the reference the port's GDN/MoE trunk is tested against.  No kernel, cache
or batching beyond one pass over whole sequences, the GDN in its recurrent
form a position at a time; it imports neither JAX nor the port.

It reads HF-keyed weights (``language_model.model.layers.{i}.*``) and
writes the forward pass from the equations of ``modeling_qwen3_next``
(Qwen3-Next-80B-A3B's ``config.json`` as ``lc``):

- norms ``x / rms(x) · (1 + w)`` (eps ``rms_norm_eps``); layer i is full
  attention where ``(i + 1) % full_attention_interval == 0``, else GDN;
- GDN: ``in_proj_qkvz`` split per key head into q ``Dk``, k ``Dk``, v and z
  ``r·Dv`` each (``r`` value heads a key head), ``in_proj_ba`` into b and
  a ``r`` each; the causal depthwise conv (width K, no bias) over ``[q ‖ k
  ‖ v]`` and SiLU; q, k L2-normalised (eps 1e-6 inside the root), q times
  ``Dk^-½``, key head h serving value heads ``r·h .. r·h + r - 1``; ``β =
  sigmoid(b)``, ``g = −exp(A_log)·softplus(a + dt_bias)``; per value head
  ``S ← e^g S``, ``u = β(v − Sᵀk)``, ``S ← S + k uᵀ``, ``o = Sᵀq``; then
  ``rms(o) · w · silu(z)`` per value head and ``out_proj``;
- full attention: ``q_proj`` per head ``[query ‖ gate]``, ``q_norm`` and
  ``k_norm`` per head, rotate-half rope on the first ``head_dim ·
  partial_rotary_factor`` dims, causal GQA softmax at ``head_dim^-½``, the
  output times ``sigmoid(gate)``, ``o_proj``;
- MoE: router logits ``h·Wrᵀ``, softmax over all experts, top-k,
  renormalised under ``norm_topk_prob``; ``Σ wᵢ·Eᵢ(h)`` over the experts
  held (``held = (e0, n)``: the experts ``[e0, e0 + n)``, all by default)
  plus ``sigmoid(h·w_sg) · shared(h)``.

A left-padded position (``mask`` 0) has conv input 0, β = 0 and g = 0 and is
no key, so padding changes no output of a valid position.  Departures:
everything in float32 (HF computes in bf16 with fp32 softmaxes, router and
state); weights optionally quantized per output row and dequantized
(``weight_levels``), as the program's int8 trunk stores them, the routers,
the shared-expert gates, the conv and the norms never; multi-token
prediction (MTP) is left out.  Switches that make the controls:
``state_dtype`` (the recurrent state rounded to it after each position),
``offset=False`` (norm scales ``w`` in place of ``1 + w``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


@contextlib.contextmanager
def full_fp32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def quantize_rows(wt: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-output-row symmetric quantization in ``wt``'s dtype (quotient
    rounded half to even, scale ``amax / levels`` in fp32 cast to that
    dtype), returned as the float32 matrix it stands for."""
    s = (wt.float().abs().amax(dim=-1) / levels).clamp_min(1e-12)
    sb = s.to(wt.dtype)
    q = torch.round(wt / sb[:, None]).clamp(-levels, levels)
    return q.float() * sb.float()[:, None]


def _mat(w: Weights, key: str, levels: Optional[int], dtype) -> torch.Tensor:
    wt = w[key]
    return quantize_rows(wt.to(dtype), levels) if levels else wt.float()


def norm(x: torch.Tensor, w: torch.Tensor, eps: float, offset: bool = True) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * \
        ((1.0 + w.float()) if offset else w.float())


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def is_full(lc: dict, i: int) -> bool:
    return (i + 1) % lc["full_attention_interval"] == 0


def rope(x: torch.Tensor, pos: torch.Tensor, lc: dict) -> torch.Tensor:
    """Rotate-half rope on the first ``head_dim · partial_rotary_factor``
    dims of x [B, T, H, Dh], pos [B, T]."""
    rot = int(lc["head_dim"] * lc.get("partial_rotary_factor", 1.0))
    inv = 1.0 / float(lc["rope_theta"]) ** (
        torch.arange(0, rot, 2, dtype=torch.float64) / rot)
    ang = pos.double()[..., None] * inv.to(x.device)
    cos, sin = torch.cos(ang).float()[:, :, None], torch.sin(ang).float()[:, :, None]
    a, b, rest = x[..., :rot // 2], x[..., rot // 2:rot], x[..., rot:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, rest], dim=-1)


def gdn(w: Weights, lc: dict, pre: str, h: torch.Tensor, mask: torch.Tensor,
        levels, dtype, state_dtype=None) -> torch.Tensor:
    """One GDN mixer over ``h`` [B, T, D] (``pre``: the layer's
    ``linear_attn.``), the delta rule a position at a time."""
    B, T, _ = h.shape
    hk, hv = lc["linear_num_key_heads"], lc["linear_num_value_heads"]
    dk, dv, K = lc["linear_key_head_dim"], lc["linear_value_head_dim"], \
        lc["linear_conv_kernel_dim"]
    r = hv // hk
    eps = lc.get("rms_norm_eps", 1e-6)
    valid = (mask != 0).float()
    qkvz = (h @ _mat(w, pre + "in_proj_qkvz.weight", levels, dtype).T).view(
        B, T, hk, 2 * dk + 2 * r * dv)
    ba = (h @ _mat(w, pre + "in_proj_ba.weight", levels, dtype).T).view(B, T, hk, 2 * r)
    q, k = qkvz[..., :dk], qkvz[..., dk:2 * dk]
    v = qkvz[..., 2 * dk:2 * dk + r * dv].reshape(B, T, hv, dv)
    z = qkvz[..., 2 * dk + r * dv:].reshape(B, T, hv, dv)
    b, a = ba[..., :r].reshape(B, T, hv), ba[..., r:].reshape(B, T, hv)
    x = torch.cat([q.reshape(B, T, -1), k.reshape(B, T, -1), v.reshape(B, T, -1)], -1)
    x = x * valid[..., None]
    cw = w[pre + "conv1d.weight"].float()[:, 0]                        # [C, K]
    xp = F.pad(x, (0, 0, K - 1, 0))
    conv = F.silu(sum(xp[:, j:j + T] * cw[:, j] for j in range(K)))
    q = l2norm(conv[..., :hk * dk].reshape(B, T, hk, dk)) * dk ** -0.5
    k = l2norm(conv[..., hk * dk:2 * hk * dk].reshape(B, T, hk, dk))
    v = conv[..., 2 * hk * dk:].reshape(B, T, hv, dv)
    q, k = q.repeat_interleave(r, dim=2), k.repeat_interleave(r, dim=2)
    beta = torch.sigmoid(b) * valid[..., None]
    g = -torch.exp(w[pre + "A_log"].float()) * F.softplus(a + w[pre + "dt_bias"].float())
    g = g * valid[..., None]
    S = torch.zeros((B, hv, dk, dv), device=h.device)
    out = []
    for t in range(T):
        S = S * torch.exp(g[:, t])[..., None, None]
        kv_mem = (S * k[:, t, :, :, None]).sum(-2)
        u = (v[:, t] - kv_mem) * beta[:, t, :, None]
        S = S + k[:, t, :, :, None] * u[:, :, None, :]
        if state_dtype is not None:
            S = S.to(state_dtype).float()
        out.append((S * q[:, t, :, :, None]).sum(-2))
    o = torch.stack(out, dim=1)                                        # [B, T, Hv, Dv]
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + eps) \
        * w[pre + "norm.weight"].float() * F.silu(z)
    return o.reshape(B, T, hv * dv) @ _mat(w, pre + "out_proj.weight", levels, dtype).T


def attention(w: Weights, lc: dict, pre: str, h: torch.Tensor, mask: torch.Tensor,
              pos: torch.Tensor, levels, dtype, offset: bool = True) -> torch.Tensor:
    """One gated full-attention mixer over ``h`` [B, T, D] (``pre``: the
    layer's ``self_attn.``)."""
    B, T, _ = h.shape
    H, Hkv, D = lc["num_attention_heads"], lc["num_key_value_heads"], lc["head_dim"]
    eps = lc.get("rms_norm_eps", 1e-6)
    qg = (h @ _mat(w, pre + "q_proj.weight", levels, dtype).T).view(B, T, H, 2 * D)
    q, gate = qg[..., :D], qg[..., D:]
    k = (h @ _mat(w, pre + "k_proj.weight", levels, dtype).T).view(B, T, Hkv, D)
    v = (h @ _mat(w, pre + "v_proj.weight", levels, dtype).T).view(B, T, Hkv, D)
    q = rope(norm(q, w[pre + "q_norm.weight"], eps, offset), pos, lc)
    k = rope(norm(k, w[pre + "k_norm.weight"], eps, offset), pos, lc)
    k, v = k.repeat_interleave(H // Hkv, dim=2), v.repeat_interleave(H // Hkv, dim=2)
    ok = torch.tril(torch.ones(T, T, dtype=torch.bool, device=h.device))[None, None] \
        & (mask[:, None, None, :] != 0)
    s = torch.einsum("bthd,bshd->bhts", q, k) * D ** -0.5
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1).nan_to_num(0.0)
    a = torch.einsum("bhts,bshd->bthd", p, v) * torch.sigmoid(gate)
    return a.reshape(B, T, H * D) @ _mat(w, pre + "o_proj.weight", levels, dtype).T


def _mlp(w, pre, h, levels, dtype):
    g = h @ _mat(w, pre + "gate_proj.weight", levels, dtype).T
    u = h @ _mat(w, pre + "up_proj.weight", levels, dtype).T
    return (F.silu(g) * u) @ _mat(w, pre + "down_proj.weight", levels, dtype).T


def moe(w: Weights, lc: dict, pre: str, h: torch.Tensor, levels, dtype,
        held=None, shared: bool = True) -> torch.Tensor:
    """One MoE FFN over tokens ``h`` [N, D] (``pre``: the layer's ``mlp.``):
    each held expert applied to the tokens that chose it, plus the gated
    shared expert (``shared``)."""
    k = lc["num_experts_per_tok"]
    scores = torch.softmax(h @ w[pre + "gate.weight"].float().T, dim=-1)
    top_w, top_i = torch.topk(scores, k, dim=-1)
    if lc.get("norm_topk_prob"):
        top_w = top_w / top_w.sum(-1, keepdim=True)
    e0, n = held or (0, scores.shape[-1])
    y = torch.zeros_like(h)
    for e in range(e0, e0 + n):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            out = _mlp(w, f"{pre}experts.{e}.", h[tok], levels, dtype)
            y.index_add_(0, tok, out * top_w[tok, slot][:, None])
    if shared:
        gate = torch.sigmoid(h @ w[pre + "shared_expert_gate.weight"].float().T)
        y = y + gate * _mlp(w, pre + "shared_expert.", h, levels, dtype)
    return y


def forward(w: Weights, lc: dict, embeds: torch.Tensor, mask: torch.Tensor,
            weight_levels: Optional[int] = None, dtype=torch.bfloat16, held=None,
            state_dtype=None, offset: bool = True,
            prefix: str = "language_model.model.") -> torch.Tensor:
    """Final-norm hidden states [B, T, D] of ``embeds`` [B, T, D] with key
    validity ``mask`` [B, T] (left padding): rope positions count the valid
    tokens."""
    x = embeds.float()
    B, T, D = x.shape
    eps = lc.get("rms_norm_eps", 1e-6)
    pos = (torch.cumsum(mask.long(), -1) - 1).clamp_min(0)
    lv = weight_levels
    for i in range(lc["num_hidden_layers"]):
        pre = f"{prefix}layers.{i}."
        h = norm(x, w[pre + "input_layernorm.weight"], eps, offset)
        if is_full(lc, i):
            x = x + attention(w, lc, pre + "self_attn.", h, mask, pos, lv, dtype, offset)
        else:
            x = x + gdn(w, lc, pre + "linear_attn.", h, mask, lv, dtype, state_dtype)
        h = norm(x, w[pre + "post_attention_layernorm.weight"], eps, offset)
        x = x + moe(w, lc, pre + "mlp.", h.reshape(B * T, D), lv, dtype,
                    held).view(B, T, D)
    return norm(x, w[prefix + "norm.weight"], eps, offset)
