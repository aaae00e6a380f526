"""A Janus model on a DeepSeek-V2 trunk in plain PyTorch, float32, TF32 off:
the benchmark's reference for the MLA/MoE cells.

It reads the HF-keyed bf16 weights the benchmark made and works out again
what the program derives from them: int8 (or, for a control, int4)
per-row weights of every projection, the shared experts and the routed
experts; the router gate stays in the model's dtype, its logits computed in
float32.  No kernel, cache or batching: each call is one pass over whole
sequences, a layer at a time, the routed experts applied expert by expert
to the tokens that chose them.

Equations (``modeling_deepseek``, DeepSeek-V2-Lite): ``h = rms(x)``; ``q =
Wq·h`` per head ``[q_nope ‖ q_pe]``; ``[c ‖ k_pe] = Wkv_a·h``, ``c =
rms(c)``; ``[k_nope ‖ v] = Wkv_b·c`` per head; YaRN rope on ``q_pe`` and
the heads' shared ``k_pe`` (the interleaved pairs, written de-interleaved);
causal ``softmax(q·k · s)`` with ``s = (dn + dr)^-½ · mscale²``; ``x +=
Wo·(p·v)``; then ``x += FFN(rms(x))``: a dense SiLU MLP in the first
``first_k_dense_replace`` layers, else ``Σ wᵢ·Eᵢ(h)`` over the top-k of the
router's softmax (weights unnormalised unless ``norm_topk_prob``) plus the
shared MLP.  Departure: everything in float32 (the model computes in bf16
with fp32 softmaxes and router).  The generation aligner, head and VQ
decode are ``reference/janus.py``'s.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from reference.janus import (Weights, f32, gen_embeds, gen_head, model_dtype,
                             quantize_rows, rms_norm)

PRE = "language_model.model."


def yarn(lc: dict):
    """→ (inv_freq [dr/2] float64, cos/sin factor, softmax scale)."""
    dr = lc["qk_rope_head_dim"]
    base = float(lc.get("rope_theta", 10000.0))
    rs = lc.get("rope_scaling") or {}
    extra = 1.0 / base ** (torch.arange(0, dr, 2, dtype=torch.float64) / dr)
    scale = (lc["qk_nope_head_dim"] + dr) ** -0.5
    factor = float(rs.get("factor", 1.0))
    if factor <= 1:
        return extra, 1.0, scale

    def mscale(m):
        return 0.1 * m * math.log(factor) + 1.0

    def corr(rot):
        return dr * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) \
            / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dr - 1)
    ramp = ((torch.arange(dr // 2, dtype=torch.float64) - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    keep = 1.0 - ramp
    inv = extra / factor * (1 - keep) + extra * keep
    return (inv, mscale(rs["mscale"]) / mscale(rs["mscale_all_dim"]),
            scale * mscale(rs["mscale_all_dim"]) ** 2)


def rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor, cs: float) -> torch.Tensor:
    """x [S, N, H, dr], pos [N]: pairs (2i, 2i + 1) rotated, written
    de-interleaved."""
    ang = pos.double()[:, None] * inv.to(x.device)
    cos = (torch.cos(ang) * cs).float()[None, :, None]
    sin = (torch.sin(ang) * cs).float()[None, :, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _mat(w: Weights, key: str, levels: Optional[int], dtype) -> torch.Tensor:
    return quantize_rows(w[key].to(dtype), levels) if levels else f32(w, key)


def _mlp(w, pre, h, levels, dtype):
    g = h @ _mat(w, pre + "gate_proj.weight", levels, dtype).T
    u = h @ _mat(w, pre + "up_proj.weight", levels, dtype).T
    return (F.silu(g) * u) @ _mat(w, pre + "down_proj.weight", levels, dtype).T


def moe(w: Weights, lc: dict, pre: str, h: torch.Tensor, levels, expert_levels,
        norm_topk: bool, dtype) -> torch.Tensor:
    """The MoE FFN of tokens ``h`` [N, D]; ``pre`` the layer's ``mlp.``."""
    k = lc["num_experts_per_tok"]
    scores = torch.softmax(h @ f32(w, pre + "gate.weight").T, dim=-1)
    top_w, top_i = torch.topk(scores, k, dim=-1)
    if norm_topk:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    top_w = top_w * float(lc.get("routed_scaling_factor", 1.0))
    y = torch.zeros_like(h)
    for e in range(lc["n_routed_experts"]):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            out = _mlp(w, f"{pre}experts.{e}.", h[tok], expert_levels, dtype)
            y.index_add_(0, tok, out * top_w[tok, slot][:, None])
    if lc.get("n_shared_experts"):
        y = y + _mlp(w, pre + "shared_experts.", h, levels, dtype)
    return y


def cfg_logits(w: Weights, cfg: dict, rows: Sequence[tuple], cfg_weight: float,
               weight_levels: int, expert_levels: Optional[int] = None,
               norm_topk: Optional[bool] = None) -> List[torch.Tensor]:
    """Teacher-forced classifier-free-guidance logits of images, as
    ``reference.janus.cfg_logits`` computes them for the LLaMA trunk:
    ``rows`` (prompt ids, uncond prompt ids, served image tokens [n_img]);
    each row's cond and uncond sequences, prompt then its tokens fed back
    through the generation aligner, exact attention over every position.
    Weights quantized per row with ``weight_levels`` (routed experts with
    ``expert_levels``, the same by default); ``norm_topk`` overrides the
    configuration's.  The layers run over all rows at once, the MoE over
    all their tokens.  → fused float32 logits [n_img, V] a row."""
    lc = cfg["language_config"]
    dt = model_dtype(cfg)
    H = lc["num_attention_heads"]
    dn, dr, dv = lc["qk_nope_head_dim"], lc["qk_rope_head_dim"], lc["v_head_dim"]
    R = lc["kv_lora_rank"]
    eps = lc.get("rms_norm_eps", 1e-6)
    e_levels = weight_levels if expert_levels is None else expert_levels
    norm = bool(lc.get("norm_topk_prob")) if norm_topk is None else norm_topk
    inv, cs, scale = yarn(lc)
    xs, ps = [], []
    for ids, uncond, tokens in rows:
        both = torch.tensor([list(ids), list(uncond)], device=tokens.device)
        emb = f32(w, PRE + "embed_tokens.weight")[both]
        img = gen_embeds(w, cfg, tokens[:-1])
        xs.append(torch.cat([emb, img[None].expand(2, -1, -1)], dim=1))
        ps.append(len(ids))
    lv = weight_levels
    for i in range(lc["num_hidden_layers"]):
        pre = f"{PRE}layers.{i}."
        wq = _mat(w, pre + "self_attn.q_proj.weight", lv, dt)
        wa = _mat(w, pre + "self_attn.kv_a_proj_with_mqa.weight", lv, dt)
        wb = _mat(w, pre + "self_attn.kv_b_proj.weight", lv, dt)
        wo = _mat(w, pre + "self_attn.o_proj.weight", lv, dt)
        n1 = f32(w, pre + "input_layernorm.weight")
        nkv = f32(w, pre + "self_attn.kv_a_layernorm.weight")
        for r, x in enumerate(xs):
            n = x.shape[1]
            pos = torch.arange(n, device=x.device)
            h = rms_norm(x, n1, eps)
            q = (h @ wq.T).view(2, n, H, dn + dr)
            ckv = h @ wa.T
            c = rms_norm(ckv[..., :R], nkv, eps)
            kv = (c @ wb.T).view(2, n, H, dn + dv)
            qq = torch.cat([q[..., :dn], rope(q[..., dn:], pos, inv, cs)], -1)
            k_pe = rope(ckv[..., None, R:], pos, inv, cs).expand(2, n, H, dr)
            kk = torch.cat([kv[..., :dn], k_pe], -1)
            s = torch.einsum("bthd,bshd->bhts", qq, kk) * scale
            s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
            p = torch.softmax(s, dim=-1)
            a = torch.einsum("bhts,bshd->bthd", p, kv[..., dn:]).reshape(2, n, H * dv)
            xs[r] = x + a @ wo.T
        del wq, wa, wb, wo
        n2 = f32(w, pre + "post_attention_layernorm.weight")
        hs = [rms_norm(x, n2, eps) for x in xs]
        flat = torch.cat([h.reshape(-1, h.shape[-1]) for h in hs])
        if i < lc.get("first_k_dense_replace", 0):
            out = _mlp(w, pre + "mlp.", flat, lv, dt)
        else:
            out = moe(w, lc, pre + "mlp.", flat, lv, e_levels, norm, dt)
        off = 0
        for r, x in enumerate(xs):
            m = x.shape[0] * x.shape[1]
            xs[r] = x + out[off:off + m].view_as(x)
            off += m
        del hs, flat, out
    res = []
    for x, p in zip(xs, ps):
        hid = rms_norm(x[:, p - 1:], f32(w, PRE + "norm.weight"), eps)
        logits = gen_head(w, hid)
        res.append(logits[1] + cfg_weight * (logits[0] - logits[1]))
    return res
