"""Kimi Linear trunk (Kimi Delta Attention beside NoPE latent attention,
sigmoid-routed experts with a shared expert) in plain PyTorch, float32, TF32
off: the reference the port's KDA/MLA/MoE trunk is tested against.  No
kernel, cache or batching beyond one pass over whole sequences, KDA in its
recurrent form a position at a time; it imports neither JAX nor the port.

It reads HF-keyed weights (``language_model.model.layers.{i}.*``) and
writes the forward pass from the equations of the release's
``modeling_kimi`` (Kimi-Linear-48B-A3B's ``config.json`` as ``lc``):

- norms ``x / rms(x) · w`` (eps ``rms_norm_eps``); ``linear_attn_config``'s
  ``kda_layers`` (1-indexed) run KDA, its ``full_attn_layers`` MLA;
- KDA: ``q_proj``, ``k_proj``, ``v_proj`` (``H·D`` each), each through its
  own causal depthwise conv (``{q,k,v}_conv1d``, width K, no bias) and
  SiLU; q, k L2-normalised per head (eps 1e-6 inside the root), q times
  ``D^-½``; ``g = −exp(A_log[h])·softplus(f_b(f_a(x)) + dt_bias)`` a
  vector over the head's key rows, ``β = sigmoid(b_proj(x))``; per head
  ``S ← Diag(e^g) S``, ``u = β(v − Sᵀk)``, ``S ← S + k uᵀ``, ``o = Sᵀq``;
  then ``rms(o)·w·sigmoid(g_b(g_a(x)))`` per head (``o_norm``), ``o_proj``;
- MLA (DeepSeek-V2's, ``q_lora_rank`` null): ``q_proj`` per head ``[q_nope
  ‖ q_pe]``, ``[c ‖ k_pe] = kv_a_proj_with_mqa(h)``, c normed by
  ``kv_a_layernorm``, ``[k_nope ‖ v] = kv_b_proj(c)`` per head, keys
  ``[k_nope ‖ k_pe]`` with ``k_pe`` shared by the heads; ``mla_use_nope``:
  no rope, the rope dims enter the scores as projected; causal softmax at
  ``(dn + dr)^-½``, ``o_proj``;
- FFN: the first ``first_k_dense_replace`` layers ``mlp.{gate,up,down}_proj``
  (SiLU); the rest MoE: ``s = sigmoid(h·Wrᵀ)``, the top-k of ``s +
  e_score_correction_bias``, weights the chosen ``s`` renormalised over
  ``(Σ + 1e-20)`` (``moe_renormalize``) times ``routed_scaling_factor``;
  ``Σ wᵢ·Eᵢ(h)`` (``experts.{e}.w1`` gate, ``w3`` up, ``w2`` down) over
  the experts held (``held = (e0, n)``, all by default) plus the shared
  MLP ``shared_experts.*`` with weight 1.

A left-padded position (``mask`` 0) has conv input 0, β = 0 and g = 0 and
is no key, so padding changes no output of a valid position.  Departures:
everything in float32 (the release computes in bf16 with fp32 routers and
state); weights optionally quantized per output row and dequantized
(``weight_levels``), as the program's int8 trunk stores them, the routers,
the conv and the norms never.  Switches that make the controls:
``state_dtype`` (the recurrent state rounded to it after each position),
``scalar_decay`` (each head decays by the mean of its g over the key rows:
a GDN's scalar decay), ``rope`` (MLA rotated, the DeepSeek-V2 way, at
``rope_theta``).  :func:`kda_step` runs one decode position of every KDA
layer from given projections, conv windows and states, for the check of a
program's recurrent states.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
PRE = "language_model.model."


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


def norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def is_kda(lc: dict, i: int) -> bool:
    """Layer ``i`` (0-indexed) runs KDA."""
    return i + 1 in lc["linear_attn_config"]["kda_layers"]


def _decay(g: torch.Tensor, scalar_decay: bool) -> torch.Tensor:
    return g.mean(-1, keepdim=True).expand_as(g) if scalar_decay else g


def _delta(S, k, v, beta, g, state_dtype=None):
    """One position of the delta rule for every row and head: ``S`` ``[...,
    H, Dk, Dv]``, k ``[..., H, Dk]``, v ``[..., H, Dv]``, β ``[..., H]`` and
    g ``[..., H, Dk]`` → the new S."""
    S = S * torch.exp(g)[..., :, None]
    u = (v - (S * k[..., :, None]).sum(-2)) * beta[..., None]
    S = S + k[..., :, None] * u[..., None, :]
    return S if state_dtype is None else S.to(state_dtype).float()


def kda(w: Weights, lc: dict, pre: str, h: torch.Tensor, mask: torch.Tensor, levels,
        dtype, state_dtype=None, scalar_decay: bool = False) -> torch.Tensor:
    """One KDA mixer over ``h`` [B, T, D] (``pre``: the layer's
    ``self_attn.``), the delta rule a position at a time."""
    B, T, _ = h.shape
    la = lc["linear_attn_config"]
    H, D, K = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    eps = lc.get("rms_norm_eps", 1e-5)
    valid = (mask != 0).float()
    proj = lambda name, x: x @ _mat(w, pre + name + ".weight", levels, dtype).T  # noqa: E731
    act = []
    for n in "qkv":
        x = proj(f"{n}_proj", h) * valid[..., None]
        cw = w[pre + f"{n}_conv1d.weight"].float()[:, 0]               # [C, K]
        xp = F.pad(x, (0, 0, K - 1, 0))
        act.append(F.silu(sum(xp[:, j:j + T] * cw[:, j] for j in range(K))).view(B, T, H, D))
    q, k, v = l2norm(act[0]) * D ** -0.5, l2norm(act[1]), act[2]
    f = proj("f_b_proj", proj("f_a_proj", h)).view(B, T, H, D)
    g = -torch.exp(w[pre + "A_log"].float().reshape(H, 1)) \
        * F.softplus(f + w[pre + "dt_bias"].float().view(H, D))
    g = _decay(g, scalar_decay) * valid[..., None, None]
    beta = torch.sigmoid(proj("b_proj", h)) * valid[..., None]
    S = torch.zeros((B, H, D, D), device=h.device)
    out = []
    for t in range(T):
        S = _delta(S, k[:, t], v[:, t], beta[:, t], g[:, t], state_dtype)
        out.append((S * q[:, t, :, :, None]).sum(-2))
    o = torch.stack(out, dim=1)                                        # [B, T, H, D]
    gate = torch.sigmoid(proj("g_b_proj", proj("g_a_proj", h))).view(B, T, H, D)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + eps) \
        * w[pre + "o_norm.weight"].float() * gate
    return proj("o_proj", o.reshape(B, T, H * D))


def kda_layers(w: Weights, lc: dict) -> dict:
    """Every KDA layer's conv weights ``[L, 1, K, 3·H·D]``, ``A_log`` ``[L, 1,
    H, 1]`` and ``dt_bias`` ``[L, 1, H, D]`` in float32, stacked in layer
    order, for :func:`kda_step`."""
    la = lc["linear_attn_config"]
    H = la["num_heads"]
    pres = [f"{PRE}layers.{i - 1}.self_attn." for i in sorted(la["kda_layers"])]
    conv = [torch.cat([w[p + f"{n}_conv1d.weight"].float()[:, 0] for n in "qkv"]).T
            for p in pres]
    return {"conv": torch.stack(conv)[:, None],
            "A_log": torch.stack([w[p + "A_log"].float().reshape(H, 1) for p in pres])[:, None],
            "dt_bias": torch.stack([w[p + "dt_bias"].float().view(H, -1)
                                    for p in pres])[:, None]}


def kda_step(lc: dict, layers: dict, x: torch.Tensor, f: torch.Tensor, b: torch.Tensor,
             conv: torch.Tensor, S: torch.Tensor, state_dtype=None,
             scalar_decay: bool = False):
    """One decode position of every KDA layer at once, :func:`kda`'s
    equations, from the projections ``x`` ``[L, B, 3·H·D]`` (q, k, v before
    the conv), ``f`` ``[L, B, H·D]`` (f_b's output) and ``b`` ``[L, B, H]``
    (as given), the conv windows ``conv`` ``[L, B, K - 1, 3·H·D]`` (the
    previous inputs), the states ``S`` ``[L, B, H, Dk, Dv]`` and
    :func:`kda_layers`' weights → (S, conv) after the position."""
    la = lc["linear_attn_config"]
    H, D = la["num_heads"], la["head_dim"]
    lead = x.shape[:-1]
    win = torch.cat([conv, x.float()[..., None, :]], dim=-2)          # [L, B, K, C]
    act = F.silu((win * layers["conv"]).sum(-2)).view(*lead, 3, H, D)
    k, v = l2norm(act[..., 1, :, :]), act[..., 2, :, :]
    g = -torch.exp(layers["A_log"]) * F.softplus(f.float().view(*lead, H, D)
                                                 + layers["dt_bias"])
    beta = torch.sigmoid(b.float())
    return _delta(S, k, v, beta, _decay(g, scalar_decay), state_dtype), win[..., 1:, :]


def mla(w: Weights, lc: dict, pre: str, h: torch.Tensor, mask: torch.Tensor,
        pos: torch.Tensor, levels, dtype, rope: bool = False) -> torch.Tensor:
    """One MLA mixer over ``h`` [B, T, D] in the expanded form (``pre``: the
    layer's ``self_attn.``); ``rope``: the control that rotates the rope
    dims (interleaved pairs, θ ``rope_theta``)."""
    B, T, _ = h.shape
    H, dn, dr = lc["num_attention_heads"], lc["qk_nope_head_dim"], lc["qk_rope_head_dim"]
    R, dv = lc["kv_lora_rank"], lc["v_head_dim"]
    eps = lc.get("rms_norm_eps", 1e-5)
    q = (h @ _mat(w, pre + "q_proj.weight", levels, dtype).T).view(B, T, H, dn + dr)
    ckv = h @ _mat(w, pre + "kv_a_proj_with_mqa.weight", levels, dtype).T
    c = norm(ckv[..., :R], w[pre + "kv_a_layernorm.weight"], eps)
    kv = (c @ _mat(w, pre + "kv_b_proj.weight", levels, dtype).T).view(B, T, H, dn + dv)
    q_pe, k_pe = q[..., dn:], ckv[..., None, R:].expand(B, T, H, dr)
    if rope:
        inv = 1.0 / float(lc.get("rope_theta", 10000.0)) ** (
            torch.arange(0, dr, 2, dtype=torch.float64) / dr)
        ang = (pos.double()[..., None] * inv.to(h.device)).float()[:, :, None]
        rot = torch.polar(torch.ones_like(ang), ang)
        q_pe, k_pe = (torch.view_as_real(torch.view_as_complex(
            t.contiguous().view(B, T, H, dr // 2, 2)) * rot).flatten(-2) for t in (q_pe, k_pe))
    qf = torch.cat([q[..., :dn], q_pe], -1)
    kf = torch.cat([kv[..., :dn], k_pe], -1)
    ok = torch.tril(torch.ones(T, T, dtype=torch.bool, device=h.device))[None, None] \
        & (mask[:, None, None, :] != 0)
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * (dn + dr) ** -0.5
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1).nan_to_num(0.0)
    a = torch.einsum("bhts,bshd->bthd", p, kv[..., dn:])
    return a.reshape(B, T, H * dv) @ _mat(w, pre + "o_proj.weight", levels, dtype).T


def _mlp(w, pre, names, h, levels, dtype):
    g, u, d = (_mat(w, f"{pre}{n}.weight", levels, dtype) for n in names)
    return (F.silu(h @ g.T) * (h @ u.T)) @ d.T


def route(w: Weights, lc: dict, pre: str, h: torch.Tensor):
    """The sigmoid router of tokens ``h`` [N, D] (``pre``: the layer's
    ``block_sparse_moe.``) → (expert ids [N, k], weights [N, k])."""
    s = torch.sigmoid(h @ w[pre + "gate.weight"].float().T)
    ids = torch.topk(s + w[pre + "gate.e_score_correction_bias"].float(),
                     lc["num_experts_per_token"], dim=-1).indices
    top_w = s.gather(1, ids)
    if lc.get("moe_renormalize"):
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    return ids, top_w * lc.get("routed_scaling_factor", 1.0)


def moe(w: Weights, lc: dict, pre: str, h: torch.Tensor, levels, dtype,
        held=None, shared: bool = True) -> torch.Tensor:
    """One MoE FFN over tokens ``h`` [N, D]: each held expert applied to the
    tokens that chose it, plus the shared MLP (``shared``)."""
    top_i, top_w = route(w, lc, pre, h)
    e0, n = held or (0, w[pre + "gate.weight"].shape[0])
    y = torch.zeros_like(h)
    for e in range(e0, e0 + n):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            out = _mlp(w, f"{pre}experts.{e}.", ("w1", "w3", "w2"), h[tok], levels, dtype)
            y.index_add_(0, tok, out * top_w[tok, slot][:, None])
    if shared:
        y = y + _mlp(w, pre + "shared_experts.", ("gate_proj", "up_proj", "down_proj"), h,
                     levels, dtype)
    return y


def forward(w: Weights, lc: dict, embeds: torch.Tensor, mask: torch.Tensor,
            weight_levels: Optional[int] = None, dtype=torch.bfloat16, held=None,
            state_dtype=None, scalar_decay: bool = False, rope: bool = False,
            prefix: str = PRE) -> torch.Tensor:
    """Final-norm hidden states [B, T, D] of ``embeds`` [B, T, D] with key
    validity ``mask`` [B, T] (left padding)."""
    x = embeds.float()
    B, T, D = x.shape
    eps = lc.get("rms_norm_eps", 1e-5)
    pos = (torch.cumsum(mask.long(), -1) - 1).clamp_min(0)
    lv = weight_levels
    for i in range(lc["num_hidden_layers"]):
        pre = f"{prefix}layers.{i}."
        h = norm(x, w[pre + "input_layernorm.weight"], eps)
        if is_kda(lc, i):
            x = x + kda(w, lc, pre + "self_attn.", h, mask, lv, dtype, state_dtype,
                        scalar_decay)
        else:
            x = x + mla(w, lc, pre + "self_attn.", h, mask, pos, lv, dtype, rope)
        h = norm(x, w[pre + "post_attention_layernorm.weight"], eps).reshape(B * T, D)
        if i < lc.get("first_k_dense_replace", 0):
            f = _mlp(w, pre + "mlp.", ("gate_proj", "up_proj", "down_proj"), h, lv, dtype)
        else:
            f = moe(w, lc, pre + "block_sparse_moe.", h, lv, dtype, held)
        x = x + f.view(B, T, D)
    return norm(x, w[prefix + "norm.weight"], eps)
