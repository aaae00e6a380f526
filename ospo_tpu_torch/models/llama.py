"""Llama-architecture decoder (the Janus-Pro language model) in PyTorch —
counterpart of ``ospo_tpu/models/llama.py``.

Parameters are a plain dict shaped like the JAX package's tree: per-layer
weights stacked on a leading layer axis in torch layout ``[out, in]``, each
projection either a tensor or an int8 ``{"q", "s"}`` dict
(``ops/quant.py``).  The layer loop is a Python loop over the stack.

The KV cache is preallocated in the batch-minor ``shbd`` layout
``[L, S, H, B, Dh]`` and updated in place (PyTorch tensors are mutable; the
JAX package threads a new cache through its scan instead).  Prefill
(``self_attn=True``) writes the prompt rows and attends over them with the
flash kernel; a cached T=1 step writes its row and reads the cache with the
decode-attention kernel.  Numerics follow the reference: weights in the
model dtype, RMSNorm / RoPE / softmax / SiLU in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ospo_tpu_torch.ops.attention import attention
from ospo_tpu_torch.ops.decode_attention import decode_attention
from ospo_tpu_torch.ops.quant import quantized_matmul

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 102400
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 30
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None → MHA
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_seq_len: int = 4096
    dtype: Any = torch.bfloat16

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dim_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


# DeepSeek-LLM-7B-base — the Janus-Pro-7B language config
LLAMA_7B = LlamaConfig()
# DeepSeek-LLM-1.3B — the Janus-Pro-1B language config
LLAMA_1B = LlamaConfig(hidden_size=2048, intermediate_size=5632, num_layers=24,
                       num_heads=16)


def tiny_config(vocab_size: int = 512, hidden_size: int = 64,
                intermediate_size: int = 128, num_layers: int = 2,
                num_heads: int = 4, max_seq_len: int = 512,
                dtype: Any = torch.float32) -> LlamaConfig:
    return LlamaConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                       intermediate_size=intermediate_size,
                       num_layers=num_layers, num_heads=num_heads,
                       max_seq_len=max_seq_len, dtype=dtype)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics; the normalised value is cast to x's dtype BEFORE the
    weight multiply (``llama.py:129-132``)."""
    xf = x.float()
    rms = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return ((xf * rms).to(x.dtype) * weight).to(x.dtype)


def rope_frequencies(cfg: LlamaConfig, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables for the given positions ([B, T] → [B, T, Dh/2])."""
    dh = cfg.dim_head
    exponent = torch.arange(0, dh, 2, dtype=torch.float32,
                            device=positions.device) / dh
    inv_freq = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                            device=positions.device), exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF-Llama rotate-half convention in fp32. x: [B, T, H, Dh]."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """y = x @ wᵀ for a plain or an int8 ``{"q", "s"}`` weight."""
    if isinstance(w, dict):
        return quantized_matmul(x, w)
    return x @ w.T


def _layer(layers: Params, li: int) -> Params:
    """Layer ``li``'s slice of the stacked weights (views, no copies)."""
    return {name: ({k: t[li] for k, t in w.items()} if isinstance(w, dict)
                   else w[li]) for name, w in layers.items()}


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  quantized=False, layout: str = "shbd",
                  device=None) -> Dict[str, Any]:
    """Preallocated batch-minor cache ``[L, S, H, B, Dh]``: model-dtype
    payload, or int8 with ``[L, S, H, B]`` fp32 scales
    (``quantized=True``/``"int8"``).  ``length`` is a host integer."""
    if layout != "shbd":
        raise NotImplementedError(
            f"kv_layout {layout!r}: the port has the batch-minor 'shbd' cache "
            "only; 'bshd'/'bhsd' are queued in ROADMAP.md (slice 5, opt-in "
            "modes)")
    if quantized not in (False, True, "int8"):
        raise NotImplementedError(
            f"kv_quant {quantized!r}: int4 KV is queued in ROADMAP.md "
            "(slice 5, opt-in modes)")
    shape = (cfg.num_layers, max_len, cfg.kv_heads, batch, cfg.dim_head)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "length": 0,
        }
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "length": 0,
    }


def _quantize_rows(x: torch.Tensor):
    """[..., Dh] → (int8 values, fp32 scales [...]) per row (``llama.py:289``)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def _write_kv(cache: Dict[str, Any], li: int, start: int,
              k: torch.Tensor, v: torch.Tensor) -> None:
    """Write fresh [B, T, H, Dh] rows at positions [start, start + T)."""
    end = start + k.shape[1]
    kw = k.permute(1, 2, 0, 3)   # → cache row order [T, H, B, Dh]
    vw = v.permute(1, 2, 0, 3)
    if "k_s" in cache:
        kq, ks = _quantize_rows(kw)
        vq, vs = _quantize_rows(vw)
        cache["k"][li, start:end] = kq
        cache["v"][li, start:end] = vq
        cache["k_s"][li, start:end] = ks
        cache["v_s"][li, start:end] = vs
    else:
        cache["k"][li, start:end] = kw.to(cache["k"].dtype)
        cache["v"][li, start:end] = vw.to(cache["v"].dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params: Params, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
            attention_mask: torch.Tensor, positions: torch.Tensor,
            kv_cache: Optional[Dict[str, Any]] = None,
            self_attn: bool = False,
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the decoder trunk; returns (final-norm hidden states, cache).

    Without a cache: ``attention_mask`` is ``[B, T]`` and attention is causal
    over the inputs.  ``self_attn=True`` (prefill into an empty cache):
    writes the T rows and attends over them, mask ``[B, T]``.  A cached T=1
    step writes its row at ``cache['length']`` and reads positions
    ``[0, length + 1)`` of the cache; ``attention_mask`` covers the whole
    cache window ``[B, S_max]`` (int32).
    """
    x = inputs_embeds.to(cfg.dtype)
    B, T = x.shape[:2]
    cos, sin = rope_frequencies(cfg, positions)
    cache_len = kv_cache["length"] if kv_cache is not None else 0
    if kv_cache is not None and not self_attn:
        if T != 1:
            raise NotImplementedError(
                "cached multi-token steps (speculative Jacobi) are queued in "
                "ROADMAP.md (slice 5, opt-in modes)")
        if cfg.kv_heads != cfg.num_heads:
            raise NotImplementedError("the decode-attention kernel is MHA only")
    if self_attn and (kv_cache is None or cache_len != 0):
        raise ValueError("self_attn prefill needs an empty cache")

    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q = linear(h, lp["wq"]).view(B, T, cfg.num_heads, cfg.dim_head)
        k = linear(h, lp["wk"]).view(B, T, cfg.kv_heads, cfg.dim_head)
        v = linear(h, lp["wv"]).view(B, T, cfg.kv_heads, cfg.dim_head)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if kv_cache is not None:
            _write_kv(kv_cache, li, cache_len, k, v)
        if kv_cache is None or self_attn:
            attn = attention(q, k, v, mask=attention_mask)
        else:
            attn = decode_attention(q, kv_cache["k"], kv_cache["v"], li,
                                    cache_len + 1, attention_mask,
                                    k_scale=kv_cache.get("k_s"),
                                    v_scale=kv_cache.get("v_s"))
        x = x + linear(attn.reshape(B, T, cfg.num_heads * cfg.dim_head), lp["wo"])
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        gate = linear(h, lp["w_gate"])
        up = linear(h, lp["w_up"])
        act = F.silu(gate.float()).to(h.dtype) * up
        x = x + linear(act, lp["w_down"])

    if kv_cache is not None:
        kv_cache["length"] = cache_len + T
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), kv_cache


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids]


def positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Rotary positions for left-padded batches: cumsum of validity − 1,
    clipped at 0 (``llama.py:787``)."""
    return (torch.cumsum(attention_mask.to(torch.int32), dim=-1) - 1).clamp_min(0)
