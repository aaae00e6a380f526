"""A Janus model on a Kimi Linear trunk in plain PyTorch, float32, TF32 off:
the benchmark's reference for the KDA/MLA/MoE cells.

It reads the HF-keyed weights the benchmark made and works out again what
the program derives from them: int8 (or, for a control, int4) per-row
weights of every projection (the KDA layers' low-rank ones too), the dense
MLP, the shared expert and the held routed experts; the routers, the
correction biases, the convs and the norms stay as made, their products in
float32.  No kernel or cache: Kimi Delta Attention (KDA) runs in its
recurrent form a position at a time over fp32 state, MLA in its expanded
form, every layer over a block of whole sequences at once (left-padded to
the block's longest; a padded position has conv input 0, β = 0, g = 0 and
is no key, so it changes no other position), the routed experts expert by
expert over the tokens that chose them.  ``kda_step`` runs one decode
position of every KDA layer from given projections, conv windows and
states, for the check of a program's recurrent states.

Equations (the release's ``modeling_kimi``, Kimi-Linear-48B-A3B): norms ``x
/ rms(x) · w`` (eps 1e-5); ``linear_attn_config.kda_layers`` (1-indexed)
KDA, its ``full_attn_layers`` MLA.  KDA: ``q_proj``, ``k_proj``, ``v_proj``
(32 heads of 128), each through its own causal depthwise conv of width 4
and SiLU; q, k L2-normalised (eps 1e-6), q times 128^-½; ``g =
−exp(A_log[h])·softplus(f_b(f_a(x)) + dt_bias)`` over a head's 128 key
rows, ``β = sigmoid(b_proj(x))``; per head ``S ← Diag(e^g) S``, ``u = β(v −
Sᵀk)``, ``S ← S + k uᵀ``, ``o = Sᵀq``; ``rms(o)·w·sigmoid(g_b(g_a(x)))``,
``o_proj``.  MLA: DeepSeek-V2's without ``q_lora_rank`` and, under
``mla_use_nope``, without rope: the 64 rope dims of q and of the shared
``k_pe`` enter the scores as projected, at 192^-½.  FFN: layer 1 a SiLU MLP
of 9216; the others MoE: ``s = sigmoid(h·Wrᵀ)``, the top-8 of ``s +
e_score_correction_bias``, weights the chosen ``s`` over ``(Σ + 1e-20)``
times 2.446, ``Σ wᵢ·Eᵢ(h)`` over the experts this chip holds
(``expert_parallel``; ``w1`` gate, ``w3`` up, ``w2`` down) plus the shared
MLP with weight 1.  Departures: everything in float32 (the release computes
in bf16 with fp32 routers and state); the keys are the configuration's
inferred ones (``assumed.hf_keys``).  The generation aligner, head and VQ
decode are ``reference/janus.py``'s.
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
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-5) * w.float()


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def _delta(S, k, v, beta, g, state_dtype=None):
    """One position of the delta rule for every row and head: ``S`` ``[...,
    H, Dk, Dv]``, k ``[..., H, Dk]``, v ``[..., H, Dv]``, β ``[..., H]``, g
    ``[..., H, Dk]`` → the new S; ``state_dtype`` rounds it (a control)."""
    S = S * torch.exp(g)[..., :, None]
    u = (v - torch.einsum("...kv,...k->...v", S, k)) * beta[..., None]
    S = S + k[..., :, None] * u[..., None, :]
    return S if state_dtype is None else S.to(state_dtype).float()


def kda(w: Weights, lc: dict, pre: str, h: torch.Tensor, valid: torch.Tensor,
        levels, dtype) -> torch.Tensor:
    """One KDA mixer over ``h`` [B, T, D]."""
    B, T, _ = h.shape
    la = lc["linear_attn_config"]
    H, D, K = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]

    def proj(name, x):
        return x @ _mat(w, pre + name + ".weight", levels, dtype).T

    act = []
    for n in "qkv":
        x = proj(f"{n}_proj", h) * valid[..., None]
        cw = f32(w, pre + f"{n}_conv1d.weight")[:, 0]
        xp = F.pad(x, (0, 0, K - 1, 0))
        act.append(F.silu(sum(xp[:, j:j + T] * cw[:, j] for j in range(K))).view(B, T, H, D))
    q, k, v = l2norm(act[0]) * D ** -0.5, l2norm(act[1]), act[2]
    f = proj("f_b_proj", proj("f_a_proj", h)).view(B, T, H, D)
    g = -torch.exp(f32(w, pre + "A_log").reshape(H, 1)) \
        * F.softplus(f + f32(w, pre + "dt_bias").view(H, D))
    g = g * valid[..., None, None]
    beta = torch.sigmoid(proj("b_proj", h)) * valid[..., None]
    S = torch.zeros((B, H, D, D), device=h.device)
    o = torch.empty((B, T, H, D), device=h.device)
    for t in range(T):
        S = _delta(S, k[:, t], v[:, t], beta[:, t], g[:, t])
        o[:, t] = torch.einsum("bhkv,bhk->bhv", S, q[:, t])
    gate = torch.sigmoid(proj("g_b_proj", proj("g_a_proj", h))).view(B, T, H, D)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + 1e-5) \
        * f32(w, pre + "o_norm.weight") * gate
    return proj("o_proj", o.reshape(B, T, H * D))


def kda_layers(w: Weights, lc: dict) -> dict:
    """Every KDA layer's conv weights ``[L, 1, K, 3·H·D]``, ``A_log`` ``[L, 1,
    H, 1]`` and ``dt_bias`` ``[L, 1, H, D]`` in float32, stacked in layer
    order, for :func:`kda_step`."""
    H = lc["linear_attn_config"]["num_heads"]
    pres = [f"{PRE}layers.{i - 1}.self_attn."
            for i in sorted(lc["linear_attn_config"]["kda_layers"])]
    conv = [torch.cat([f32(w, p + f"{n}_conv1d.weight")[:, 0] for n in "qkv"]).T
            for p in pres]
    return {"conv": torch.stack(conv)[:, None],
            "A_log": torch.stack([f32(w, p + "A_log").reshape(H, 1) for p in pres])[:, None],
            "dt_bias": torch.stack([f32(w, p + "dt_bias").view(H, -1) for p in pres])[:, None]}


def kda_step(lc: dict, layers: dict, x: torch.Tensor, f: torch.Tensor, b: torch.Tensor,
             conv: torch.Tensor, S: torch.Tensor, state_dtype=None,
             scalar_decay: bool = False):
    """One decode position of every KDA layer at once, :func:`kda`'s
    equations, from the projections ``x`` ``[L, B, 3·H·D]`` (q, k, v before
    the conv), ``f`` ``[L, B, H·D]`` (f_b's output) and ``b`` ``[L, B, H]``
    (as given), the conv windows ``conv`` ``[L, B, K - 1, 3·H·D]`` (the
    previous inputs), the states ``S`` ``[L, B, H, Dk, Dv]`` and
    :func:`kda_layers`' weights → (S, conv) after the position.  Controls:
    ``state_dtype`` rounds the state; ``scalar_decay`` decays each head by
    the mean of its g (a GDN's arithmetic)."""
    la = lc["linear_attn_config"]
    H, D = la["num_heads"], la["head_dim"]
    lead = x.shape[:-1]
    win = torch.cat([conv, x.float()[..., None, :]], dim=-2)          # [L, B, K, C]
    act = F.silu((win * layers["conv"]).sum(-2)).view(*lead, 3, H, D)
    k, v = l2norm(act[..., 1, :, :]), act[..., 2, :, :]
    g = -torch.exp(layers["A_log"]) * F.softplus(f.float().view(*lead, H, D)
                                                 + layers["dt_bias"])
    if scalar_decay:
        g = g.mean(-1, keepdim=True).expand_as(g)
    return _delta(S, k, v, torch.sigmoid(b.float()), g, state_dtype), win[..., 1:, :]


def mla(w: Weights, lc: dict, pre: str, h: torch.Tensor, valid: torch.Tensor,
        levels, dtype) -> torch.Tensor:
    """One NoPE MLA mixer over ``h`` [B, T, D] in the expanded form."""
    B, T, _ = h.shape
    H, dn, dr = lc["num_attention_heads"], lc["qk_nope_head_dim"], lc["qk_rope_head_dim"]
    R, dv = lc["kv_lora_rank"], lc["v_head_dim"]
    q = (h @ _mat(w, pre + "q_proj.weight", levels, dtype).T).view(B, T, H, dn + dr)
    ckv = h @ _mat(w, pre + "kv_a_proj_with_mqa.weight", levels, dtype).T
    c = norm(ckv[..., :R], w[pre + "kv_a_layernorm.weight"])
    kv = (c @ _mat(w, pre + "kv_b_proj.weight", levels, dtype).T).view(B, T, H, dn + dv)
    k = torch.cat([kv[..., :dn], ckv[..., None, R:].expand(B, T, H, dr)], -1)
    ok = torch.tril(torch.ones(T, T, dtype=torch.bool, device=h.device))[None, None] \
        & valid[:, None, None, :].bool()
    s = torch.einsum("bthd,bshd->bhts", q, k) * (dn + dr) ** -0.5
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1).nan_to_num(0.0)
    a = torch.einsum("bhts,bshd->bthd", p, kv[..., dn:])
    return a.reshape(B, T, H * dv) @ _mat(w, pre + "o_proj.weight", levels, dtype).T


def _mlp(w, pre, names, h, levels, dtype):
    g, u, d = (_mat(w, f"{pre}{n}.weight", levels, dtype) for n in names)
    return (F.silu(h @ g.T) * (h @ u.T)) @ d.T


def moe(w: Weights, lc: dict, pre: str, h: torch.Tensor, levels, dtype) -> torch.Tensor:
    """The MoE FFN of tokens ``h`` [N, D] over the experts this chip holds;
    ``pre`` the layer's ``block_sparse_moe.``."""
    ep = lc.get("expert_parallel") or {}
    e0, held = ep.get("first_held", 0), lc["num_experts"]
    s = torch.sigmoid(h @ f32(w, pre + "gate.weight").T)
    top_i = torch.topk(s + f32(w, pre + "gate.e_score_correction_bias"),
                       lc["num_experts_per_token"], dim=-1).indices
    top_w = s.gather(1, top_i)
    if lc.get("moe_renormalize"):
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    top_w = top_w * lc.get("routed_scaling_factor", 1.0)
    y = torch.zeros_like(h)
    for e in range(e0, e0 + held):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            out = _mlp(w, f"{pre}experts.{e}.", ("w1", "w3", "w2"), h[tok], levels, dtype)
            y.index_add_(0, tok, out * top_w[tok, slot][:, None])
    return y + _mlp(w, pre + "shared_experts.", ("gate_proj", "up_proj", "down_proj"), h,
                    levels, dtype)


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
    B, _, D = x.shape
    kda_set = set(lc["linear_attn_config"]["kda_layers"])
    for i in range(lc["num_hidden_layers"]):
        pre = f"{PRE}layers.{i}."
        h = norm(x, w[pre + "input_layernorm.weight"])
        mixer = kda if i + 1 in kda_set else mla
        x = x + mixer(w, lc, pre + "self_attn.", h, valid, weight_levels, dt)
        h = norm(x, w[pre + "post_attention_layernorm.weight"]).reshape(B * T, D)
        if i < lc["first_k_dense_replace"]:
            f = _mlp(w, pre + "mlp.", ("gate_proj", "up_proj", "down_proj"), h,
                     weight_levels, dt)
        else:
            f = moe(w, lc, pre + "block_sparse_moe.", h, weight_levels, dt)
        x = x + f.view(B, T, D)
    out = []
    for r, (s, p) in enumerate(zip(seqs, ps)):
        start = T - s.shape[1] + p - 1
        hid = norm(x[2 * r:2 * r + 2, start:], w[PRE + "norm.weight"])
        logits = gen_head(w, hid)
        out.append(logits[1] + cfg_weight * (logits[0] - logits[1]))
    return out
