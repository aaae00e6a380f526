"""Janus-Pro in plain PyTorch, float32, TF32 off: the benchmark's reference.

It reads the HF-keyed bf16 weights the benchmark made and works out again
everything the program derives from them: int8 (or, for the control, int4)
per-row weights and per-(position, head) int8 KV values.  No kernel, cache
or batching: each call is one pass over whole sequences, one layer at a time.

Equations (DeepSeek-LLM / LLaMA block): ``x += Wo·attn(rope(Wq·n1(x)),
rope(Wk·n1(x)), Wv·n1(x))``; ``x += Wd·(silu(Wg·n2(x)) * Wu·n2(x))``; RMSNorm
``x / sqrt(mean(x²) + eps) · w``; rotate-half RoPE on ``arange`` positions
over the valid tokens; causal softmax attention scaled by ``dh ** -0.5``.
The generation head is Linear → GELU (erf) → Linear; the generation
aligner Linear → GELU → Linear over the 8-wide ``gen_embed`` rows.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


@contextlib.contextmanager
def full_fp32():
    """Matrix products and convolutions in full float32 (TF32 off)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def f32(w: Weights, key: str) -> torch.Tensor:
    return w[key].float()


def quantize_rows(wt: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-output-row symmetric quantization of a matrix in the model's
    dtype, returned as the float32 matrix it stands for: scale
    ``amax / levels`` in float32, the quotient taken in the model's dtype
    and rounded half to even, the scale applied in that dtype (``levels``
    127: int8; 7: int4)."""
    s = (wt.float().abs().amax(dim=-1) / levels).clamp_min(1e-12)
    sb = s.to(wt.dtype)
    q = torch.round(wt / sb[:, None]).clamp(-levels, levels)
    return q.float() * sb.float()[:, None]


def quantize_kv(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-(row, position, head) symmetric quantization over the head dim,
    dequantized: what a cached read of an int8 (127) or int4 (7) cache sees."""
    s = (x.abs().amax(dim=-1, keepdim=True) / levels).clamp_min(1e-12)
    return torch.round(x / s).clamp(-levels, levels) * s


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, N, H, Dh], pos [B, N] (rotate-half convention)."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device,
                                       dtype=torch.float32) / dh)
    ang = pos.float()[..., None] * inv
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    a, b = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q, k, v, q_offset: int = 0) -> torch.Tensor:
    """Causal attention of queries at positions ``q_offset + i`` over keys
    0..N-1.  q [B, Tq, H, Dh], k/v [B, N, H, Dh] → [B, Tq, H·Dh]."""
    b, tq, h, dh = q.shape
    n = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    qi = torch.arange(tq, device=q.device)[:, None] + q_offset
    ki = torch.arange(n, device=q.device)[None, :]
    s = s.masked_fill(ki > qi, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, tq, h * dh)


PROJ = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
        "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
        "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
        "w_down": "mlp.down_proj"}


def model_dtype(cfg: dict) -> torch.dtype:
    return {"float32": torch.float32}.get(cfg.get("torch_dtype"), torch.bfloat16)


def layer_weights(w: Weights, li: int, weight_levels: Optional[int],
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s float32 matrices ([out, in]) and norm scales, each
    projection quantized per row in ``dtype`` when ``weight_levels`` is
    set."""
    pre = f"language_model.model.layers.{li}."
    out = {name: (quantize_rows(w[f"{pre}{hf}.weight"].to(dtype), weight_levels)
                  if weight_levels else f32(w, f"{pre}{hf}.weight"))
           for name, hf in PROJ.items()}
    out["attn_norm"] = f32(w, pre + "input_layernorm.weight")
    out["mlp_norm"] = f32(w, pre + "post_attention_layernorm.weight")
    return out


def mlp_gelu(w: Weights, prefix: str, depth: int, x: torch.Tensor) -> torch.Tensor:
    for d in range(depth):
        i = 0 if d == 0 else 2 * d
        if d:
            x = F.gelu(x)
        x = x @ f32(w, f"{prefix}layers.{i}.weight").T + f32(w, f"{prefix}layers.{i}.bias")
    return x


def gen_head(w: Weights, hidden: torch.Tensor) -> torch.Tensor:
    x = F.gelu(hidden @ f32(w, "gen_head.output_mlp_projector.weight").T
               + f32(w, "gen_head.output_mlp_projector.bias"))
    return x @ f32(w, "gen_head.vision_head.weight").T + f32(w, "gen_head.vision_head.bias")


def gen_embeds(w: Weights, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    depth = cfg["gen_aligner_config"]["params"]["depth"]
    return mlp_gelu(w, "gen_aligner.", depth, f32(w, "gen_embed.weight")[ids])


def cfg_logits(w: Weights, cfg: dict, rows: Sequence[tuple], cfg_weight: float,
               weight_levels: int, kv_levels: int) -> List[torch.Tensor]:
    """Teacher-forced classifier-free-guidance logits of images.

    ``rows``: (prompt ids, uncond prompt ids, served image tokens [n_img])
    a row.  Each row's cond and uncond sequences are its prompt (length P)
    followed by its tokens fed back through the generation aligner.  The
    logits at the prompt's last position come from attention over exact
    keys and values (the prefill); those at image positions from attention
    over keys and values quantized per position and head with
    ``kv_levels`` (a cached decode).  Weights are quantized per row with
    ``weight_levels``.  → fused float32 logits [n_img, V] a row:
    ``u + cfg_weight · (c − u)``."""
    lc = cfg["language_config"]
    heads = lc["num_attention_heads"]
    dh = lc["hidden_size"] // heads
    eps = lc.get("rms_norm_eps", 1e-6)
    theta = lc.get("rope_theta", 10000.0)
    xs, ps = [], []
    for ids, uncond, tokens in rows:
        dev = tokens.device
        both = torch.tensor([list(ids), list(uncond)], device=dev)
        emb = f32(w, "language_model.model.embed_tokens.weight")[both]
        img = gen_embeds(w, cfg, tokens[:-1])
        xs.append(torch.cat([emb, img[None].expand(2, -1, -1)], dim=1))
        ps.append(len(ids))
    for li in range(lc["num_hidden_layers"]):
        lw = layer_weights(w, li, weight_levels, model_dtype(cfg))
        for r, (x, p) in enumerate(zip(xs, ps)):
            n = x.shape[1]
            pos = torch.arange(n, device=x.device)[None].expand(2, n)
            h = rms_norm(x, lw["attn_norm"], eps)
            q = rope((h @ lw["wq"].T).view(2, n, heads, dh), pos, theta)
            k = rope((h @ lw["wk"].T).view(2, n, heads, dh), pos, theta)
            v = (h @ lw["wv"].T).view(2, n, heads, dh)
            a_pre = attention(q[:, :p], k[:, :p], v[:, :p])
            a_dec = attention(q[:, p:], quantize_kv(k, kv_levels),
                              quantize_kv(v, kv_levels), q_offset=p)
            x = x + torch.cat([a_pre, a_dec], dim=1) @ lw["wo"].T
            h = rms_norm(x, lw["mlp_norm"], eps)
            xs[r] = x + (F.silu(h @ lw["w_gate"].T) * (h @ lw["w_up"].T)) @ lw["w_down"].T
    out = []
    for x, p in zip(xs, ps):
        hid = rms_norm(x[:, p - 1:], f32(w, "language_model.model.norm.weight"), eps)
        logits = gen_head(w, hid)
        out.append(logits[1] + cfg_weight * (logits[0] - logits[1]))
    return out


# ---------------------------------------------------------------------------
# VQ-16
# ---------------------------------------------------------------------------

def _conv(w: Weights, name: str, x: torch.Tensor, stride: int = 1,
          pad: Optional[int] = None) -> torch.Tensor:
    wt = f32(w, name + ".weight")
    k = wt.shape[-1]
    return F.conv2d(x, wt, f32(w, name + ".bias"), stride=stride,
                    padding=k // 2 if pad is None else pad)


def _gn(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x, min(32, x.shape[1]), f32(w, name + ".weight"), f32(w, name + ".bias"), 1e-6)


def _swish(x):
    return x * torch.sigmoid(x)


def _res(w, name, x):
    h = _conv(w, name + ".conv1", _swish(_gn(w, name + ".norm1", x)))
    h = _conv(w, name + ".conv2", _swish(_gn(w, name + ".norm2", h)))
    if name + ".nin_shortcut.weight" in w:
        x = _conv(w, name + ".nin_shortcut", x)
    return x + h


def _attn(w, name, x):
    n, c, hh, ww = x.shape
    hn = _gn(w, name + ".norm", x)
    q = _conv(w, name + ".q", hn).reshape(n, c, -1).transpose(1, 2)
    k = _conv(w, name + ".k", hn).reshape(n, c, -1)
    v = _conv(w, name + ".v", hn).reshape(n, c, -1).transpose(1, 2)
    p = torch.softmax(q @ k * c ** -0.5, dim=-1)
    out = (p @ v).transpose(1, 2).reshape(n, c, hh, ww)
    return x + _conv(w, name + ".proj_out", out)


def _blocks(w, prefix, x, level_range, n_res, resample):
    for bi in level_range:
        base = f"{prefix}.conv_blocks.{bi}"
        for j in range(n_res):
            x = _res(w, f"{base}.res.{j}", x)
            if f"{base}.attn.{j}.q.weight" in w:
                x = _attn(w, f"{base}.attn.{j}", x)
        if f"{base}.{resample}.conv.weight" in w:
            if resample == "upsample":
                x = _conv(w, f"{base}.upsample.conv",
                          F.interpolate(x, scale_factor=2, mode="nearest"))
            else:
                x = _conv(w, f"{base}.downsample.conv", F.pad(x, (0, 1, 0, 1)),
                          stride=2, pad=0)
    return x


def _mid(w, prefix, x):
    x = _res(w, prefix + ".mid.0", x)
    x = _attn(w, prefix + ".mid.1", x)
    return _res(w, prefix + ".mid.2", x)


def _codebook(w: Weights) -> torch.Tensor:
    cb = f32(w, "gen_vision_model.quantize.embedding.weight")
    return cb / torch.linalg.vector_norm(cb, dim=-1, keepdim=True)


def vq_decode(w: Weights, vq: dict, ids: torch.Tensor) -> torch.Tensor:
    """Codebook ids [n, side²] → uint8 pixels [n, H, W, 3] (values
    ``(x + 1) · 127.5``, clipped, truncated)."""
    n, t = ids.shape
    side = int(round(t ** 0.5))
    z = _codebook(w)[ids].reshape(n, side, side, -1).permute(0, 3, 1, 2)
    pre = "gen_vision_model."
    x = _conv(w, pre + "post_quant_conv", z)
    x = _conv(w, pre + "decoder.conv_in", x)
    x = _mid(w, pre + "decoder", x)
    x = _blocks(w, pre + "decoder", x, range(len(vq["ch_mult"])),
                vq["num_res_blocks"] + 1, "upsample")
    x = _conv(w, pre + "decoder.conv_out", _swish(_gn(w, pre + "decoder.norm_out", x)))
    return ((x.permute(0, 2, 3, 1) + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def vq_encode(w: Weights, vq: dict, pixels: torch.Tensor) -> torch.Tensor:
    """Normalized pixels [n, H, W, 3] → codebook ids [n, h·w]: the nearest
    l2-normalized code to each l2-normalized latent."""
    pre = "gen_vision_model."
    x = _conv(w, pre + "encoder.conv_in", pixels.permute(0, 3, 1, 2))
    x = _blocks(w, pre + "encoder", x, range(len(vq["ch_mult"])),
                vq["num_res_blocks"], "downsample")
    x = _mid(w, pre + "encoder", x)
    x = _conv(w, pre + "encoder.conv_out", _swish(_gn(w, pre + "encoder.norm_out", x)))
    z = _conv(w, pre + "quant_conv", x).permute(0, 2, 3, 1)
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-12)
    flat = z.reshape(-1, z.shape[-1])
    cb = _codebook(w)
    d = (flat * flat).sum(-1, keepdim=True) - 2 * flat @ cb.T + (cb * cb).sum(-1)
    return torch.argmin(d, dim=-1).reshape(z.shape[0], -1)


def gap_per_position(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best each chosen token's reference
    logit lies: ref [T, V], chosen [T] → [T]."""
    return ref.max(dim=-1).values - ref.gather(-1, chosen[:, None])[:, 0]


def served_gap(ref: torch.Tensor, served: torch.Tensor) -> float:
    return float(gap_per_position(ref, served).max())
