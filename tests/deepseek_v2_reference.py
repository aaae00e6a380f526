"""DeepSeek-V2 trunk (MLA, YaRN rope, routed and shared experts) in plain
PyTorch, float32, TF32 off: the reference the port's MLA/MoE trunk is tested
against.  No kernel, cache or batching beyond one pass over whole
sequences; it imports neither JAX nor the port.

It reads HF-keyed weights (``language_model.model.layers.{i}.*``) and
writes the forward pass from the equations of ``modeling_deepseek``
(DeepSeek-V2-Lite's ``config.json`` as ``lc``):

- ``h = rms(x)``; ``q = Wq·h`` per head ``[q_nope ‖ q_pe]``; ``[c ‖ k_pe] =
  Wkv_a·h``; ``c = rms(c)``; ``[k_nope ‖ v] = Wkv_b·c`` per head; rope on
  ``q_pe`` and the one shared ``k_pe``; ``softmax((q·k) · s)`` with ``s =
  (dn + dr)^-½ · mscale(factor, mscale_all_dim)²``, causal over the valid
  keys; ``x += Wo·(p·v)``;
- YaRN: ``inv_freq = inter·(1 − m) + extra·m``, ``extra = θ^(-2i/dr)``,
  ``inter = extra / factor``, ``m = 1 − ramp(low, high)`` between the
  correction dims of ``beta_fast`` and ``beta_slow``; cos and sin times
  ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``; the pairs
  ``(2i, 2i + 1)`` rotated, written de-interleaved (HF's ``view(d/2,
  2).transpose``);
- FFN: dense layers ``Wd·(silu(Wg·h) ⊙ Wu·h)``; MoE layers: router logits
  ``h·Wrᵀ``, softmax, the top-k scores as weights (times
  ``routed_scaling_factor``), ``Σ wᵢ·Eᵢ(h)`` plus the shared MLP.

Departures: everything in float32 (HF computes in bf16 with fp32
softmaxes and router); weights optionally quantized per output row and
dequantized (``weight_levels``), as the program's int8 trunk stores them,
the router never.  Switches that make the controls: ``norm_topk``
(renormalised top-k weights), ``rope="half"`` (rotate-half on
non-interleaved dims), ``shared=False`` (the shared experts dropped),
``expert_levels`` (routed experts at another quantization).
"""

from __future__ import annotations

import contextlib
import math
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


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn(lc: dict):
    """→ (inv_freq [dr/2], cos/sin factor, softmax scale, (low, high))."""
    dr = lc["qk_rope_head_dim"]
    base = float(lc.get("rope_theta", 10000.0))
    rs = lc.get("rope_scaling") or {}
    extra = 1.0 / base ** (torch.arange(0, dr, 2, dtype=torch.float64) / dr)
    scale = (lc["qk_nope_head_dim"] + dr) ** -0.5
    factor = float(rs.get("factor", 1.0))
    if factor <= 1:
        return extra.float(), 1.0, scale, None
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dr * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dr - 1)
    ramp = ((torch.arange(dr // 2, dtype=torch.float64) - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    m = 1.0 - ramp
    inv = extra / factor * (1 - m) + extra * m
    cs = mscale(factor, rs["mscale"]) / mscale(factor, rs["mscale_all_dim"])
    scale *= mscale(factor, rs["mscale_all_dim"]) ** 2
    return inv.float(), cs, scale, (low, high)


def rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor, cs: float,
         kind: str = "interleaved") -> torch.Tensor:
    """x [B, T, H, dr], pos [B, T]."""
    ang = pos.double()[..., None] * inv.double().to(x.device)
    cos = (torch.cos(ang) * cs).float()[:, :, None]
    sin = (torch.sin(ang) * cs).float()[:, :, None]
    if kind == "interleaved":
        a, b = x[..., 0::2], x[..., 1::2]
    else:
        a, b = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _mat(w: Weights, key: str, levels: Optional[int], dtype) -> torch.Tensor:
    wt = w[key]
    return quantize_rows(wt.to(dtype), levels) if levels else wt.float()


def _mlp(w, pre, h, levels, dtype):
    g = h @ _mat(w, pre + "gate_proj.weight", levels, dtype).T
    u = h @ _mat(w, pre + "up_proj.weight", levels, dtype).T
    return (F.silu(g) * u) @ _mat(w, pre + "down_proj.weight", levels, dtype).T


def moe(w: Weights, lc: dict, pre: str, h: torch.Tensor, levels, dtype,
        expert_levels=None, norm_topk=None, shared: bool = True) -> torch.Tensor:
    """One MoE FFN over tokens ``h`` [N, D] (``pre``: the layer's
    ``mlp.``): each expert applied to the tokens that chose it."""
    e_levels = levels if expert_levels is None else expert_levels
    k = lc["num_experts_per_tok"]
    scores = torch.softmax(h @ w[pre + "gate.weight"].float().T, dim=-1)
    top_w, top_i = torch.topk(scores, k, dim=-1)
    if lc.get("norm_topk_prob") if norm_topk is None else norm_topk:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    top_w = top_w * float(lc.get("routed_scaling_factor", 1.0))
    y = torch.zeros_like(h)
    for e in range(lc["n_routed_experts"]):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            out = _mlp(w, f"{pre}experts.{e}.", h[tok], e_levels, dtype)
            y.index_add_(0, tok, out * top_w[tok, slot][:, None])
    if shared and lc.get("n_shared_experts"):
        y = y + _mlp(w, pre + "shared_experts.", h, levels, dtype)
    return y


def forward(w: Weights, lc: dict, embeds: torch.Tensor, mask: torch.Tensor,
            weight_levels: Optional[int] = None, dtype=torch.bfloat16,
            expert_levels: Optional[int] = None, norm_topk=None,
            rope_kind: str = "interleaved", shared: bool = True,
            prefix: str = "language_model.model.") -> torch.Tensor:
    """Final-norm hidden states [B, T, D] of ``embeds`` [B, T, D] with key
    validity ``mask`` [B, T] (left padding): rope positions count the valid
    tokens, each query attends the valid keys at or before it."""
    x = embeds.float()
    B, T, D = x.shape
    H = lc["num_attention_heads"]
    dn, dr, dv = lc["qk_nope_head_dim"], lc["qk_rope_head_dim"], lc["v_head_dim"]
    R = lc["kv_lora_rank"]
    eps = lc.get("rms_norm_eps", 1e-6)
    inv, cs, scale, _ = yarn(lc)
    pos = (torch.cumsum(mask.long(), -1) - 1).clamp_min(0)
    ok = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))[None, None] \
        & (mask[:, None, None, :] != 0)
    lv = weight_levels
    for i in range(lc["num_hidden_layers"]):
        pre = f"{prefix}layers.{i}."
        h = rms(x, w[pre + "input_layernorm.weight"].float(), eps)
        q = (h @ _mat(w, pre + "self_attn.q_proj.weight", lv, dtype).T).view(B, T, H, dn + dr)
        ckv = h @ _mat(w, pre + "self_attn.kv_a_proj_with_mqa.weight", lv, dtype).T
        c = rms(ckv[..., :R], w[pre + "self_attn.kv_a_layernorm.weight"].float(), eps)
        kv = (c @ _mat(w, pre + "self_attn.kv_b_proj.weight", lv, dtype).T).view(
            B, T, H, dn + dv)
        q_pe = rope(q[..., dn:], pos, inv, cs, rope_kind)
        k_pe = rope(ckv[..., None, R:], pos, inv, cs, rope_kind).expand(B, T, H, dr)
        qq = torch.cat([q[..., :dn], q_pe], -1)
        kk = torch.cat([kv[..., :dn], k_pe], -1)
        s = torch.einsum("bthd,bshd->bhts", qq, kk) * scale
        s = s.masked_fill(~ok, float("-inf"))
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)
        a = torch.einsum("bhts,bshd->bthd", p, kv[..., dn:]).reshape(B, T, H * dv)
        x = x + a @ _mat(w, pre + "self_attn.o_proj.weight", lv, dtype).T
        h = rms(x, w[pre + "post_attention_layernorm.weight"].float(), eps)
        if i < lc.get("first_k_dense_replace", 0):
            x = x + _mlp(w, pre + "mlp.", h, lv, dtype)
        else:
            x = x + moe(w, lc, pre + "mlp.", h.reshape(B * T, D), lv, dtype,
                        expert_levels, norm_topk, shared).view(B, T, D)
    return rms(x, w[prefix + "norm.weight"].float(), eps)
