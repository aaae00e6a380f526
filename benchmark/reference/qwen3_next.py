"""A Janus model on a Qwen3-Next trunk in plain PyTorch, float32, TF32 off:
the benchmark's reference for the GDN/MoE cells.

It reads the HF-keyed bf16 weights the benchmark made and works out again
what the program derives from them: int8 (or, for a control, int4)
per-row weights of every projection, the shared expert and the held
routed experts; the routers, the shared-expert gates, the conv and the
norms stay as made, their products in float32.  No kernel or cache: the
Gated DeltaNet runs in its recurrent form a position at a time over fp32
state, every layer over a block of whole sequences at once (left-padded
to the block's longest; a padded position has conv input 0, β = 0, g = 0
and is no key, so it changes no other position), the routed experts expert
by expert over the tokens that chose them.  ``gdn_step`` runs one decode
position of every GDN layer from given projections, conv windows and
states, for the check of a program's recurrent states.

Equations (``modeling_qwen3_next``, Qwen3-Next-80B-A3B): norms ``x / rms(x)
· (1 + w)``; layer i full attention where ``(i + 1) % 4 == 0``, else GDN.
GDN: ``in_proj_qkvz`` split per key head into q, k (128), v, z (2 × 128),
``in_proj_ba`` into b, a (2); the causal depthwise conv of width 4 over
``[q ‖ k ‖ v]`` and SiLU; q, k L2-normalised (eps 1e-6), q times 128^-½;
``β = sigmoid(b)``, ``g = −exp(A_log)·softplus(a + dt_bias)``; per value
head ``S ← e^g S``, ``u = β(v − Sᵀk)``, ``S ← S + k uᵀ``, ``o = Sᵀq``;
``rms(o)·w·silu(z)``, ``out_proj``.  Full attention: ``q_proj`` per head
``[query ‖ gate]``, ``q_norm``, ``k_norm``, rotate-half rope on the first
64 dims (θ 1e7), causal GQA softmax at 256^-½, times ``sigmoid(gate)``,
``o_proj``.  MoE: softmax over the router's 512 outputs, top-10
renormalised, ``Σ wᵢ·Eᵢ(h)`` over the experts this chip holds
(``expert_parallel``), plus ``sigmoid(h·w_sg)·shared(h)``.  Departures:
everything in float32 (HF computes in bf16 with fp32 softmaxes, router and
state); the release's multi-token prediction module is left out.  The
generation aligner, head and VQ decode are ``reference/janus.py``'s.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from reference.janus import Weights, f32, gen_embeds, gen_head, model_dtype, quantize_rows

PRE = "language_model.model."


def _mat(w: Weights, key: str, levels: Optional[int], dtype) -> torch.Tensor:
    return quantize_rows(w[key].to(dtype), levels) if levels else f32(w, key)


def norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The zero-centred RMSNorm (eps 1e-6)."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * (1.0 + w.float())


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def rope(x: torch.Tensor, pos: torch.Tensor, lc: dict) -> torch.Tensor:
    """Rotate-half rope on the first ``head_dim · partial_rotary_factor``
    dims of x [B, T, H, Dh], pos [B, T]."""
    rot = int(lc["head_dim"] * lc["partial_rotary_factor"])
    inv = 1.0 / float(lc["rope_theta"]) ** (
        torch.arange(0, rot, 2, dtype=torch.float64) / rot)
    ang = pos.double()[..., None] * inv.to(x.device)
    cos, sin = torch.cos(ang).float()[:, :, None], torch.sin(ang).float()[:, :, None]
    a, b, rest = x[..., :rot // 2], x[..., rot // 2:rot], x[..., rot:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, rest], dim=-1)


def _split(qkvz: torch.Tensor, ba: torch.Tensor, lc: dict):
    """The projections ``[..., Hk·(2Dk + 2r·Dv)]`` and ``[..., Hk·2r]`` split
    per key head → (the conv input ``[..., C]`` in ``[q ‖ k ‖ v]`` order, z
    ``[..., Hv, Dv]``, b and a ``[..., Hv]``)."""
    hk, hv = lc["linear_num_key_heads"], lc["linear_num_value_heads"]
    dk, dv = lc["linear_key_head_dim"], lc["linear_value_head_dim"]
    r, lead = hv // hk, qkvz.shape[:-1]
    qkvz = qkvz.reshape(*lead, hk, 2 * dk + 2 * r * dv)
    ba = ba.reshape(*lead, hk, 2 * r)
    q, k = qkvz[..., :dk], qkvz[..., dk:2 * dk]
    v = qkvz[..., 2 * dk:2 * dk + r * dv]
    z = qkvz[..., 2 * dk + r * dv:].reshape(*lead, hv, dv)
    b, a = ba[..., :r].reshape(*lead, hv), ba[..., r:].reshape(*lead, hv)
    x = torch.cat([q.reshape(*lead, -1), k.reshape(*lead, -1), v.reshape(*lead, -1)], -1)
    return x, z, b, a


def _heads(conv: torch.Tensor, lc: dict):
    """The conv's output ``[..., C]`` after SiLU → q (L2-normalised, times
    ``Dk^-½``), k (L2-normalised), each repeated for its value heads, and v,
    ``[..., Hv, D]``."""
    hk, hv = lc["linear_num_key_heads"], lc["linear_num_value_heads"]
    dk, dv = lc["linear_key_head_dim"], lc["linear_value_head_dim"]
    lead, r = conv.shape[:-1], hv // hk
    q = l2norm(conv[..., :hk * dk].reshape(*lead, hk, dk)) * dk ** -0.5
    k = l2norm(conv[..., hk * dk:2 * hk * dk].reshape(*lead, hk, dk))
    v = conv[..., 2 * hk * dk:].reshape(*lead, hv, dv)
    return q.repeat_interleave(r, dim=-2), k.repeat_interleave(r, dim=-2), v


def _gates(a_log: torch.Tensor, dt_bias: torch.Tensor, b: torch.Tensor, a: torch.Tensor):
    """β and g from b, a and the layer's ``A_log`` and ``dt_bias``."""
    return torch.sigmoid(b), -torch.exp(a_log) * F.softplus(a + dt_bias)


def _delta(S, k, v, beta, decay, state_dtype=None):
    """One position of the delta rule for every row and value head: ``S``
    ``[..., Hv, Dk, Dv]``, k ``[..., Hv, Dk]``, v ``[..., Hv, Dv]``, β and
    the decay ``e^g`` ``[..., Hv]`` → the new S; ``state_dtype`` rounds it
    to that dtype (a control)."""
    S = S * decay[..., None, None]
    u = (v - torch.einsum("...kv,...k->...v", S, k)) * beta[..., None]
    S = S + k[..., :, None] * u[..., None, :]
    return S if state_dtype is None else S.to(state_dtype).float()


def gdn(w: Weights, lc: dict, pre: str, h: torch.Tensor, valid: torch.Tensor,
        levels, dtype) -> torch.Tensor:
    """One GDN mixer over ``h`` [B, T, D]."""
    B, T, _ = h.shape
    hv, dk, dv, K = lc["linear_num_value_heads"], lc["linear_key_head_dim"], \
        lc["linear_value_head_dim"], lc["linear_conv_kernel_dim"]
    x, z, b, a = _split(h @ _mat(w, pre + "in_proj_qkvz.weight", levels, dtype).T,
                        h @ _mat(w, pre + "in_proj_ba.weight", levels, dtype).T, lc)
    x = x * valid[..., None]
    cw = f32(w, pre + "conv1d.weight")[:, 0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    q, k, v = _heads(F.silu(sum(xp[:, j:j + T] * cw[:, j] for j in range(K))), lc)
    beta, g = _gates(f32(w, pre + "A_log"), f32(w, pre + "dt_bias"), b, a)
    beta = beta * valid[..., None]
    decay = torch.exp(g * valid[..., None])
    S = torch.zeros((B, hv, dk, dv), device=h.device)
    o = torch.empty((B, T, hv, dv), device=h.device)
    for t in range(T):
        S = _delta(S, k[:, t], v[:, t], beta[:, t], decay[:, t])
        o[:, t] = torch.einsum("bhkv,bhk->bhv", S, q[:, t])
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + 1e-6) \
        * f32(w, pre + "norm.weight") * F.silu(z)
    return o.reshape(B, T, hv * dv) @ _mat(w, pre + "out_proj.weight", levels, dtype).T


def gdn_layers(w: Weights, lc: dict) -> dict:
    """Every GDN layer's conv weights ``[L, 1, K, C]``, ``A_log`` and
    ``dt_bias`` ``[L, 1, Hv]`` in float32, stacked in layer order, for
    :func:`gdn_step`."""
    pres = [f"{PRE}layers.{i}.linear_attn." for i in range(lc["num_hidden_layers"])
            if (i + 1) % lc["full_attention_interval"]]
    return {"conv": torch.stack([f32(w, p + "conv1d.weight")[:, 0].T for p in pres])[:, None],
            "A_log": torch.stack([f32(w, p + "A_log") for p in pres])[:, None],
            "dt_bias": torch.stack([f32(w, p + "dt_bias") for p in pres])[:, None]}


def gdn_step(lc: dict, layers: dict, qkvz: torch.Tensor, ba: torch.Tensor,
             conv: torch.Tensor, S: torch.Tensor, state_dtype=None):
    """One decode position of every GDN layer at once, :func:`gdn`'s
    equations, from the projections ``qkvz``, ``ba`` ``[L, B, ·]`` (as
    given), the conv windows ``conv`` ``[L, B, K - 1, C]`` (the previous
    inputs), the states ``S`` ``[L, B, Hv, Dk, Dv]`` and
    :func:`gdn_layers`' weights → (S, conv) after the position."""
    x, _, b, a = _split(qkvz.float(), ba.float(), lc)
    win = torch.cat([conv, x[..., None, :]], dim=-2)                 # [L, B, K, C]
    _, k, v = _heads(F.silu((win * layers["conv"]).sum(-2)), lc)
    beta, g = _gates(layers["A_log"], layers["dt_bias"], b, a)
    return _delta(S, k, v, beta, torch.exp(g), state_dtype), win[..., 1:, :]


def attention(w: Weights, lc: dict, pre: str, h: torch.Tensor, valid: torch.Tensor,
              pos: torch.Tensor, levels, dtype) -> torch.Tensor:
    B, T, _ = h.shape
    H, Hkv, D = lc["num_attention_heads"], lc["num_key_value_heads"], lc["head_dim"]
    qg = (h @ _mat(w, pre + "q_proj.weight", levels, dtype).T).view(B, T, H, 2 * D)
    q, gate = qg[..., :D], qg[..., D:]
    k = (h @ _mat(w, pre + "k_proj.weight", levels, dtype).T).view(B, T, Hkv, D)
    v = (h @ _mat(w, pre + "v_proj.weight", levels, dtype).T).view(B, T, Hkv, D)
    q = rope(norm(q, w[pre + "q_norm.weight"]), pos, lc)
    k = rope(norm(k, w[pre + "k_norm.weight"]), pos, lc)
    k, v = k.repeat_interleave(H // Hkv, dim=2), v.repeat_interleave(H // Hkv, dim=2)
    ok = torch.tril(torch.ones(T, T, dtype=torch.bool, device=h.device))[None, None] \
        & valid[:, None, None, :].bool()
    s = torch.einsum("bthd,bshd->bhts", q, k) * D ** -0.5
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1).nan_to_num(0.0)
    a = torch.einsum("bhts,bshd->bthd", p, v) * torch.sigmoid(gate)
    return a.reshape(B, T, H * D) @ _mat(w, pre + "o_proj.weight", levels, dtype).T


def _mlp(w, pre, h, levels, dtype):
    g = h @ _mat(w, pre + "gate_proj.weight", levels, dtype).T
    u = h @ _mat(w, pre + "up_proj.weight", levels, dtype).T
    return (F.silu(g) * u) @ _mat(w, pre + "down_proj.weight", levels, dtype).T


def moe(w: Weights, lc: dict, pre: str, h: torch.Tensor, levels, dtype) -> torch.Tensor:
    """The MoE FFN of tokens ``h`` [N, D] over the experts this chip holds;
    ``pre`` the layer's ``mlp.``."""
    ep = lc.get("expert_parallel") or {}
    e0, held = ep.get("first_held", 0), lc["num_experts"]
    scores = torch.softmax(h @ f32(w, pre + "gate.weight").T, dim=-1)
    top_w, top_i = torch.topk(scores, lc["num_experts_per_tok"], dim=-1)
    if lc.get("norm_topk_prob"):
        top_w = top_w / top_w.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(e0, e0 + held):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            out = _mlp(w, f"{pre}experts.{e}.", h[tok], levels, dtype)
            y.index_add_(0, tok, out * top_w[tok, slot][:, None])
    gate = torch.sigmoid(h @ f32(w, pre + "shared_expert_gate.weight").T)
    return y + gate * _mlp(w, pre + "shared_expert.", h, levels, dtype)


def cfg_logits(w: Weights, cfg: dict, rows: Sequence[tuple], cfg_weight: float,
               weight_levels: int) -> List[torch.Tensor]:
    """Teacher-forced classifier-free-guidance logits of images, as
    ``reference.janus.cfg_logits`` computes them for the LLaMA trunk:
    ``rows`` (prompt ids, uncond prompt ids, served image tokens [n_img]);
    each row's cond and uncond sequences, prompt then its tokens fed back
    through the generation aligner, every layer over all rows at once
    (left-padded to the longest).  Weights quantized per row with
    ``weight_levels``.  → fused float32 logits [n_img, V] a row."""
    lc = cfg["language_config"]
    dt = model_dtype(cfg)
    seqs, ps = [], []
    for ids, uncond, tokens in rows:
        both = torch.tensor([list(ids), list(uncond)], device=tokens.device)
        emb = f32(w, PRE + "embed_tokens.weight")[both]
        img = gen_embeds(w, cfg, tokens[:-1])
        seqs.append(torch.cat([emb, img[None].expand(2, -1, -1)], dim=1))
        ps.append(len(ids))
    T = max(s.shape[1] for s in seqs)
    x = torch.cat([F.pad(s, (0, 0, T - s.shape[1], 0)) for s in seqs])   # [2R, T, D]
    valid = torch.cat([(torch.arange(T, device=x.device) >= T - s.shape[1]).float()[None]
                       .expand(2, T) for s in seqs])
    pos = (torch.cumsum(valid, -1) - 1).clamp_min(0)
    B, _, D = x.shape
    for i in range(lc["num_hidden_layers"]):
        pre = f"{PRE}layers.{i}."
        h = norm(x, w[pre + "input_layernorm.weight"])
        if (i + 1) % lc["full_attention_interval"] == 0:
            x = x + attention(w, lc, pre + "self_attn.", h, valid, pos, weight_levels, dt)
        else:
            x = x + gdn(w, lc, pre + "linear_attn.", h, valid, weight_levels, dt)
        h = norm(x, w[pre + "post_attention_layernorm.weight"])
        x = x + moe(w, lc, pre + "mlp.", h.reshape(B * T, D), weight_levels, dt).view(B, T, D)
    out = []
    for r, (s, p) in enumerate(zip(seqs, ps)):
        start = T - s.shape[1] + p - 1
        hid = norm(x[2 * r:2 * r + 2, start:], w[PRE + "norm.weight"])
        logits = gen_head(w, hid)
        out.append(logits[1] + cfg_weight * (logits[0] - logits[1]))
    return out
