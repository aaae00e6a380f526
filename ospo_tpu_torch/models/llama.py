"""Llama-architecture decoder (the Janus-Pro language model) in PyTorch —
counterpart of ``ospo_tpu/models/llama.py``.

Parameters are a plain dict shaped like the JAX package's tree: per-layer
weights stacked on a leading layer axis in torch layout ``[out, in]``, each
projection either a tensor or a quantized dict (int8 ``{"q", "s"}``, int4
``{"q4", "s"}`` or ``{"q4", "gs"}``; ``ops/quant.py``).  The layer loop is a
Python loop over the stack.

The KV cache is preallocated in the batch-minor ``shbd`` layout
``[L, S, H, B, Dh]`` and updated in place (PyTorch tensors are mutable; the
JAX package threads a new cache through its scan instead).  Prefill
(``self_attn=True``) writes the prompt rows and attends over them with the
flash kernel; a cached T=1 step writes its row and reads the cache with the
decode-attention kernel, a cached T > 1 step its rows with the plain
``cached_attention``.  With a batch-shared prefix segment (``prefix_kv``,
the text engine's shared-prefix decode and step 4b's pre-image segment)
prefill and T = 1 take the plain prefix forms of ``ops/attention.py``
instead.  Numerics follow the reference: weights in the
model dtype, RMSNorm / RoPE / softmax / SiLU in fp32.

Without a cache the trunk is the training forward: LoRA adapters with
dropout, per-layer activation checkpointing, and attention through the
differentiable flash path (forward and backward kernels) or the plain
masked attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ospo_tpu_torch.ops.attention import (attention, cached_attention,
                                          prefix_decode_attention)
from ospo_tpu_torch.ops.decode_attention import decode_attention
from ospo_tpu_torch.ops.int4_matmul import int4_matmul_decode
from ospo_tpu_torch.ops.quant import (quantized_matmul, quantized_matmul_int4,
                                      quantized_matmul_int4_group)

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
    """y = x @ wᵀ for a plain weight or a quantized dict: int8 ``{"q", "s"}``,
    int4 ``{"q4", "s"}`` or int4 groups ``{"q4", "gs"}``.  A T == 1 int4
    product runs the decode-matmul kernel (its plain version on the CPU);
    a longer one the prefill forms of ``ops/quant.py``."""
    if not isinstance(w, dict):
        return x @ w.T
    if "q4" not in w:
        return quantized_matmul(x, w)
    if x.shape[1] == 1:
        return int4_matmul_decode(x, w)
    if "gs" in w:
        return quantized_matmul_int4_group(x, w)
    return quantized_matmul_int4(x, w)


def _layer(layers: Params, li: int) -> Params:
    """Layer ``li``'s slice of the stacked weights (views, no copies)."""
    return {name: ({k: t[li] for k, t in w.items()} if isinstance(w, dict)
                   else w[li]) for name, w in layers.items()}


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

PROJ_INDEX = {
    "q_proj": 0, "k_proj": 1, "v_proj": 2, "o_proj": 3,
    "gate_proj": 4, "up_proj": 5, "down_proj": 6,
}


def fold_seed(seed: int, i: int) -> int:
    """A new 63-bit seed from ``seed`` and an index (the counterpart of
    ``jax.random.fold_in`` for the dropout seeds; different numbers)."""
    return (seed * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) % (1 << 63)


def _maybe_lora(x: torch.Tensor, w, lora: Optional[Params], name: str,
                scaling: float, dropout_rate: float = 0.0,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
    """y = x @ wᵀ (+ scaling * (x_l @ A) @ B when an adapter exists), as in
    ``ospo_tpu/models/llama.py:163-224``: A [d_in, r] and B [r, d_out] are
    cast to x's dtype; dropout (peft semantics) applies to the adapter
    input only.  The mask is drawn from a generator seeded with
    ``fold_seed(dropout_seed, PROJ_INDEX[name])`` each call, so a
    checkpointed layer's recompute redraws the same mask."""
    y = linear(x, w)
    if lora is None or name not in lora:
        return y
    a, b = lora[name]["a"], lora[name]["b"]
    x_l = x
    if dropout_rate and dropout_seed is not None:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(fold_seed(dropout_seed, PROJ_INDEX[name]))
        keep = torch.empty_like(x).bernoulli_(1.0 - dropout_rate, generator=gen)
        x_l = x * keep / (1.0 - dropout_rate)
    return y + scaling * ((x_l @ a.to(x.dtype)) @ b.to(x.dtype))


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


def _train_layer(x: torch.Tensor, lp: Params, llora: Optional[Params],
                 cfg: LlamaConfig, cos, sin, attention_mask, scaling: float,
                 dropout_rate: float, dropout_seed: Optional[int],
                 attn_impl: str) -> torch.Tensor:
    """One layer of the no-cache path (``layer_body`` at
    ``ospo_tpu/models/llama.py:751-755``)."""
    B, T = x.shape[:2]

    def proj(h, w, name):
        return _maybe_lora(h, w, llora, name, scaling, dropout_rate,
                           dropout_seed)

    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q = proj(h, lp["wq"], "q_proj").view(B, T, cfg.num_heads, cfg.dim_head)
    k = proj(h, lp["wk"], "k_proj").view(B, T, cfg.kv_heads, cfg.dim_head)
    v = proj(h, lp["wv"], "v_proj").view(B, T, cfg.kv_heads, cfg.dim_head)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    attn = attention(q, k, v, mask=attention_mask, impl=attn_impl)
    x = x + proj(attn.reshape(B, T, cfg.num_heads * cfg.dim_head), lp["wo"],
                 "o_proj")
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    gate = proj(h, lp["w_gate"], "gate_proj")
    up = proj(h, lp["w_up"], "up_proj")
    act = F.silu(gate.float()).to(h.dtype) * up
    return x + proj(act, lp["w_down"], "down_proj")


def forward(params: Params, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
            attention_mask: torch.Tensor, positions: torch.Tensor,
            kv_cache: Optional[Dict[str, Any]] = None,
            self_attn: bool = False,
            lora: Optional[Params] = None,
            lora_scaling: float = 1.0,
            lora_dropout: float = 0.0,
            lora_dropout_seed: Optional[int] = None,
            remat: bool = False,
            attn_impl: str = "auto",
            prefix_kv: Optional[Dict[str, torch.Tensor]] = None,
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the decoder trunk; returns (final-norm hidden states, cache).

    Without a cache: ``attention_mask`` is ``[B, T]`` and attention is causal
    over the inputs.  ``self_attn=True`` (prefill into an empty cache):
    writes the T rows and attends over them, mask ``[B, T]``.  A cached
    step writes its T rows at ``cache['length']`` (one host integer for
    every row) and reads positions ``[0, length + T)`` of the cache,
    causally; ``attention_mask`` covers the whole cache window
    ``[B, S_max]`` (int32).  T = 1 runs the decode-attention kernel, T > 1
    (step 4b's question suffixes) the plain ``cached_attention``.

    Training (no cache, ``ospo_tpu/models/llama.py:325-776``): ``lora``
    ``{proj: {"a": [L, d_in, r], "b": [L, r, d_out]}}`` adds adapters with
    ``lora_scaling``; ``lora_dropout`` with a ``lora_dropout_seed`` (one per
    micro-step) drops adapter inputs, each (layer, projection) mask from its
    own seed; ``remat`` checkpoints each layer
    (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``);
    ``attn_impl`` is passed to :func:`attention` (``"flash"`` runs the
    backward kernels).

    ``prefix_kv`` ``{"k": [L, C, KVH, Dh], "v": [L, C, KVH, Dh], "mask":
    [C] | [1, C] | [B, C]}`` (cached path only) adds a batch-shared,
    read-only key/value segment before every cache row
    (``ospo_tpu/models/llama.py:373-382``): the prefill's queries attend
    prefix + own chunk, a cached step's prefix + cache, each through the
    plain forms of ``ops/attention.py``.  The caller owns the rotary
    positions, which continue after the prefix.
    """
    x = inputs_embeds.to(cfg.dtype)
    B, T = x.shape[:2]
    cos, sin = rope_frequencies(cfg, positions)
    if kv_cache is None:
        if prefix_kv is not None:
            raise ValueError("prefix_kv needs a KV cache (the serving path)")
        for li in range(cfg.num_layers):
            lp = _layer(params["layers"], li)
            llora = None if lora is None else {
                n: {"a": ab["a"][li], "b": ab["b"][li]} for n, ab in lora.items()}
            seed = (None if lora_dropout_seed is None
                    else fold_seed(lora_dropout_seed, li))
            args = (lp, llora, cfg, cos, sin, attention_mask, lora_scaling,
                    lora_dropout, seed, attn_impl)
            if remat:
                # the dropout masks come from explicit per-call generators,
                # so no global RNG state needs stashing for the recompute
                x = torch.utils.checkpoint.checkpoint(
                    _train_layer, x, *args, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x = _train_layer(x, *args)
        return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), None
    if lora is not None or remat or attn_impl != "auto":
        raise NotImplementedError(
            "LoRA, remat and attn_impl are options of the training (no-cache) "
            "path; merge adapters for generation (train/lora.merge)")
    cache_len = kv_cache["length"]
    if not isinstance(cache_len, int):
        raise NotImplementedError(
            "per-row cache offsets (speculative Jacobi) are queued in "
            "ROADMAP.md (slice 5, opt-in modes)")
    if not self_attn and T == 1 and cfg.kv_heads != cfg.num_heads:
        raise NotImplementedError("the decode-attention kernel is MHA only")
    if self_attn and cache_len != 0:
        raise ValueError("self_attn prefill needs an empty cache")

    pm = None if prefix_kv is None else prefix_kv["mask"]
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        pk = pv = None
        if prefix_kv is not None:
            pk, pv = prefix_kv["k"][li], prefix_kv["v"][li]
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q = linear(h, lp["wq"]).view(B, T, cfg.num_heads, cfg.dim_head)
        k = linear(h, lp["wk"]).view(B, T, cfg.kv_heads, cfg.dim_head)
        v = linear(h, lp["wv"]).view(B, T, cfg.kv_heads, cfg.dim_head)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        _write_kv(kv_cache, li, cache_len, k, v)
        if self_attn:
            attn = attention(q, k, v, mask=attention_mask, prefix_k=pk,
                             prefix_v=pv, prefix_mask=pm)
        elif T > 1:
            attn = cached_attention(
                q, kv_cache["k"], kv_cache["v"], li, cache_len,
                attention_mask, pk, pv, pm, k_scale=kv_cache.get("k_s"),
                v_scale=kv_cache.get("v_s"))
        elif pk is not None:
            attn = prefix_decode_attention(
                q, kv_cache["k"], kv_cache["v"], li, cache_len + 1,
                attention_mask, pk, pv, pm, k_scale=kv_cache.get("k_s"),
                v_scale=kv_cache.get("v_s"))
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

    kv_cache["length"] = cache_len + T
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), kv_cache


def logits_from_hidden(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Hidden states [B, T, D] → text logits [B, T, V]: the product in the
    model dtype, cast to fp32 (``ospo_tpu/models/llama.py:779-780``)."""
    return (hidden @ params["lm_head"].T).float()


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids]


def positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Rotary positions for left-padded batches: cumsum of validity − 1,
    clipped at 0 (``llama.py:787``)."""
    return (torch.cumsum(attention_mask.to(torch.int32), dim=-1) - 1).clamp_min(0)
