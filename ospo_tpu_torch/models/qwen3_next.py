"""Qwen3-Next decoder trunk (Gated DeltaNet linear attention beside gated
full attention, routed experts with a gated shared expert) in PyTorch, the
third trunk family of the Janus model beside ``models/llama.py`` and
``models/deepseek_v2.py``.  The JAX package has no counterpart.

Block (HF ``modeling_qwen3_next``): ``x += mixer(n1(x))``, ``x += MoE(n2(x))``
with zero-centred RMSNorms ``x / rms(x) · (1 + w)`` (fp32, eps
``rms_norm_eps``).  Layer i's mixer is gated full attention where ``(i + 1)
% full_attention_interval == 0`` and a Gated DeltaNet (GDN) layer elsewhere.

- GDN (``ops/gated_delta.py`` defines the step): ``in_proj_qkvz`` and
  ``in_proj_ba`` split per key head as ``fix_query_key_value_ordering``
  does; a causal depthwise conv of width ``linear_conv_kernel_dim`` over
  ``[q ‖ k ‖ v]``, SiLU; q and k L2-normalised, q times ``Dk^-½``; ``β =
  sigmoid(b)``, ``g = −exp(A_log)·softplus(a + dt_bias)``; the delta rule
  per value head over a ``[Dk, Dv]`` state; the gated norm ``rms(o) · w ·
  silu(z)`` (w a plain scale), then ``out_proj``.
- Gated full attention: ``q_proj`` gives per head the query and a gate of
  ``head_dim`` each; ``q_norm`` and ``k_norm`` (zero-centred) per head;
  rotate-half rope on the first ``head_dim · partial_rotary_factor`` dims;
  causal GQA softmax at ``head_dim^-½``; the output times ``sigmoid(gate)``,
  then ``o_proj``.
- MoE (``ops/moe.py``): fp32 router logits, softmax over all routed
  experts, top-k renormalised under ``norm_topk_prob``; ``Σ wᵢ·Eᵢ(h)`` plus
  the shared MLP weighted by ``sigmoid(h · w_sg)``.  An expert share: the
  layer holds the routed experts ``[first_held, first_held + held)`` of the
  ``experts`` it routes over and gives their part of the FFN.

Parameters (torch layout ``[out, in]``; projections plain or int8 ``{"q",
"s"}``): ``layers`` stacks every layer's ``attn_norm`` and ``mlp_norm``
(``1 + w`` in fp32); ``gdn`` the GDN layers' ``in_qkvz``, ``in_ba``,
``conv_w`` ``[C, K]`` (model dtype), ``A_log``, ``dt_bias`` and ``norm``
(fp32), ``out``; ``full`` the full layers' ``wq``, ``wk``, ``wv``, ``wo``,
``q_norm``, ``k_norm`` (``1 + w``, fp32); ``moe`` every layer's ``router``
``[E + 1, D]`` (model dtype, the shared gate's row last), ``w13`` ``[L, held
+ S, 2F, D]`` and ``w2`` ``[L, held + S, D, F]``: the held experts, then the
shared MLP cut into S experts of width F (``models/weights.py``).

The cache holds two kinds of state.  The full layers' keys and values
``k``, ``v`` ``[Lf, B, Hkv, S, Dh]`` (model dtype) grow by a position a
step; the GDN layers' ``gdn_state`` ``[Lg, B, Hv, Dk, Dv]`` (fp32) and
``conv_state`` ``[Lg, B, K - 1, C]`` (model dtype) have one size and are
overwritten in place every step.  Prefill writes both; a cached T = 1 step
writes its key and value at ``cache['length']`` (a host int, or an int32
tensor ``[1]`` in device memory that the step advances) and reads ``[0,
length + 1)`` of the window ``attention_mask`` admits, with a plain GQA
read, so the step reads no host value and can be captured in a CUDA graph.
The MoE's counters are ``deepseek_v2``'s: ``step_counts`` ``[L, held + S]``
and ``expert_rows`` ``[S, L, held]``.

Not ported, and refused by name: multi-token prediction (the release's MTP
module; step 3 decodes image tokens through Janus's head), tensor parallel,
an int8 or int4 cache, per-row offsets (SJD), cached T > 1 steps (step 4b's
suffixes), LoRA and the training path (step 5), the text engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ospo_tpu_torch.models.llama import apply_rope, linear, linears
from ospo_tpu_torch.ops import gated_delta, moe
from ospo_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]

NEG_FILL = -1e30


@dataclasses.dataclass(frozen=True)
class Qwen3NextConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 5120      # a dense MLP's width (no layer has one)
    num_layers: int = 48
    num_heads: int = 16
    num_kv_heads: int = 2
    head_dim: int = 256
    partial_rotary_factor: float = 0.25
    rope_theta: float = 10000000.0
    full_attention_interval: int = 4
    linear_num_key_heads: int = 16
    linear_num_value_heads: int = 32
    linear_key_head_dim: int = 128
    linear_value_head_dim: int = 128
    linear_conv_kernel_dim: int = 4
    experts: int = 512                 # routed experts the router scores
    held: int = 512                    # routed experts this layer holds
    first_held: int = 0
    moe_intermediate_size: int = 512
    shared_expert_intermediate_size: int = 512
    num_experts_per_tok: int = 10
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-6
    max_seq_len: int = 262144
    dtype: Any = torch.bfloat16

    def is_full(self, li: int) -> bool:
        return (li + 1) % self.full_attention_interval == 0

    @property
    def n_full(self) -> int:
        return sum(self.is_full(i) for i in range(self.num_layers))

    @property
    def n_gdn(self) -> int:
        return self.num_layers - self.n_full

    @property
    def n_moe(self) -> int:
        return self.num_layers

    @property
    def n_shared(self) -> int:
        return self.shared_expert_intermediate_size // self.moe_intermediate_size

    @property
    def held_range(self) -> Tuple[int, int]:
        return self.first_held, self.held

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def ratio(self) -> int:
        return self.linear_num_value_heads // self.linear_num_key_heads

    @property
    def conv_dim(self) -> int:
        return (2 * self.linear_num_key_heads * self.linear_key_head_dim
                + self.linear_num_value_heads * self.linear_value_head_dim)

    # the head count and width the step-3 benchmark driver records of any
    # trunk: the full layers' key heads
    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads

    @property
    def dim_head(self) -> int:
        return self.head_dim

    def state_bytes(self, rows: int) -> int:
        """Bytes of the recurrent and conv states of ``rows`` rows."""
        rec = (self.linear_num_value_heads * self.linear_key_head_dim
               * self.linear_value_head_dim * 4)
        conv = (self.linear_conv_kernel_dim - 1) * self.conv_dim \
            * torch.finfo(self.dtype).bits // 8
        return self.n_gdn * rows * (rec + conv)


def is_hybrid(cfg) -> bool:
    return isinstance(cfg, Qwen3NextConfig)


# how refusals name this trunk (``janus.refuse_own_trunk``)
TRUNK = "GDN/MoE trunk (Qwen3-Next)"


def config_from_hf(lc: dict, dtype) -> Qwen3NextConfig:
    """The trunk's config from the HF ``language_config`` (``model_type``
    ``qwen3_next``).  ``num_experts`` counts the experts held here; an
    ``expert_parallel`` entry (``experts``, the router's width, and
    ``first_held``) states the share, and without one every expert is
    held.  What is not ported raises."""
    for key, want in (("decoder_sparse_step", 1), ("mlp_only_layers", []),
                      ("hidden_act", "silu"), ("attention_bias", False),
                      ("use_sliding_window", False), ("rope_scaling", None)):
        if lc.get(key, want) != want:
            raise NotImplementedError(f"{key} {lc[key]!r} is not ported "
                                      f"(only {want!r})")
    ep = lc.get("expert_parallel") or {}
    held = lc["num_experts"]
    fe, fs = lc["moe_intermediate_size"], lc.get("shared_expert_intermediate_size", 0)
    if fs % fe:
        raise NotImplementedError(f"shared_expert_intermediate_size {fs}: the shared "
                                  f"MLP runs as experts of width {fe}")
    return Qwen3NextConfig(
        vocab_size=lc["vocab_size"], hidden_size=lc["hidden_size"],
        intermediate_size=lc.get("intermediate_size", 0),
        num_layers=lc["num_hidden_layers"], num_heads=lc["num_attention_heads"],
        num_kv_heads=lc["num_key_value_heads"], head_dim=lc["head_dim"],
        partial_rotary_factor=float(lc.get("partial_rotary_factor", 1.0)),
        rope_theta=float(lc.get("rope_theta", 10000.0)),
        full_attention_interval=lc["full_attention_interval"],
        linear_num_key_heads=lc["linear_num_key_heads"],
        linear_num_value_heads=lc["linear_num_value_heads"],
        linear_key_head_dim=lc["linear_key_head_dim"],
        linear_value_head_dim=lc["linear_value_head_dim"],
        linear_conv_kernel_dim=lc["linear_conv_kernel_dim"],
        experts=int(ep.get("experts", held)), held=held,
        first_held=int(ep.get("first_held", 0)),
        moe_intermediate_size=fe, shared_expert_intermediate_size=fs,
        num_experts_per_tok=lc["num_experts_per_tok"],
        norm_topk_prob=bool(lc.get("norm_topk_prob", False)),
        rms_norm_eps=lc.get("rms_norm_eps", 1e-6),
        max_seq_len=lc.get("max_position_embeddings", 262144), dtype=dtype)


def _layer(tree, li: int):
    """Layer ``li``'s slice of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return tree[li]


def zc_norm(x: torch.Tensor, w1: torch.Tensor, eps: float) -> torch.Tensor:
    """The zero-centred RMSNorm with its scale ``w1 = 1 + w`` (fp32): ``x /
    rms(x) · w1`` in fp32, rounded once to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * w1).to(x.dtype)


def rope_cos_sin(cfg: Qwen3NextConfig, positions: torch.Tensor):
    """fp32 cos and sin ``[B, T, rotary_dim / 2]``, made on the device."""
    dim, dev = cfg.rotary_dim, positions.device
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim
    inv_freq = 1.0 / torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
                                          device=dev), exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def _rope(x: torch.Tensor, cos, sin, rot: int) -> torch.Tensor:
    """Rotate-half rope on the first ``rot`` dims of x ``[B, T, H, Dh]``."""
    return torch.cat([apply_rope(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: Qwen3NextConfig, batch: int, max_len: int,
                  quantized=False, layout: str = "shbd",
                  device=None) -> Dict[str, Any]:
    """The cache of the module's docstring, zeroed.  ``layout`` is taken for
    the engines' calls; this cache has one layout."""
    if quantized:
        raise NotImplementedError(
            f"kv_quant {quantized!r}: an int8/int4 cache is not ported for the "
            "GDN/MoE trunk (its full layers keep model-dtype keys and values)")
    dt = dict(dtype=cfg.dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    kv = (cfg.n_full, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(kv, **dt), "v": torch.zeros(kv, **dt),
            "gdn_state": torch.zeros(
                (cfg.n_gdn, batch, cfg.linear_num_value_heads, cfg.linear_key_head_dim,
                 cfg.linear_value_head_dim), dtype=torch.float32, device=device),
            "conv_state": torch.zeros(
                (cfg.n_gdn, batch, cfg.linear_conv_kernel_dim - 1, cfg.conv_dim), **dt),
            "expert_rows": torch.zeros((max_len, cfg.n_moe, cfg.held), **i32),
            "step_counts": torch.zeros((cfg.n_moe, cfg.held + cfg.n_shared), **i32),
            "length": 0, "layout": "hybrid"}


# ---------------------------------------------------------------------------
# mixers
# ---------------------------------------------------------------------------


def _gdn(h: torch.Tensor, gp: Params, gi: int, kv_cache, cached: bool, valid,
         cfg: Qwen3NextConfig) -> torch.Tensor:
    B, T, _ = h.shape
    hk, dk, dv, r = (cfg.linear_num_key_heads, cfg.linear_key_head_dim,
                     cfg.linear_value_head_dim, cfg.ratio)
    qkvz, ba = linears(h, (gp["in_qkvz"], gp["in_ba"]))
    if cached:
        out = gated_delta.decode(
            qkvz[:, 0], ba[:, 0], gp["conv_w"], kv_cache["conv_state"][gi],
            kv_cache["gdn_state"][gi], gp["A_log"], gp["dt_bias"], gp["norm"],
            hk, dk, dv, r, cfg.rms_norm_eps)[:, None]
        return linear(out, gp["out"])
    x_in, z, b, a = gated_delta.split_heads(qkvz, ba, hk, dk, dv, r)
    beta, g = gated_delta.gates(b, a, gp["A_log"], gp["dt_bias"])
    if valid is not None:         # a padded position leaves both states as they were
        x_in = x_in * valid[..., None].to(x_in.dtype)
        beta, g = beta * valid[..., None], g * valid[..., None]
    q, k, v = gated_delta.qkv_heads(gated_delta.conv_prefill(x_in, gp["conv_w"]), hk, dk, r)
    o, state = gated_delta.delta_rule_chunked(q, k, v, g, beta)
    if kv_cache is not None:
        K = cfg.linear_conv_kernel_dim
        kv_cache["gdn_state"][gi].copy_(state)
        kv_cache["conv_state"][gi].copy_(F.pad(x_in, (0, 0, K - 1, 0))[:, T:])
    out = gated_delta.gated_norm(o, z, gp["norm"], cfg.rms_norm_eps, h.dtype)
    return linear(out.reshape(B, T, -1), gp["out"])


def _attend_full(q, k, v, valid, cfg: Qwen3NextConfig) -> torch.Tensor:
    """Causal GQA over the T fresh positions (prefill, no cache), scores
    and softmax in fp32; ``valid`` ``[B, T]`` key validity → ``[B, T, H,
    Dh]``."""
    B, T, H, _ = q.shape
    rep = H // cfg.num_kv_heads
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * cfg.head_dim ** -0.5
    rows = torch.arange(T, device=q.device)
    allowed = (rows[None, :] <= rows[:, None])[None, None]
    if valid is not None:
        allowed = allowed & valid[:, None, None, :]
    s = torch.where(allowed, s, torch.full_like(s, NEG_FILL))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, vf).to(q.dtype)


def _attend_cached(q, kc, vc, bias, cfg: Qwen3NextConfig) -> torch.Tensor:
    """One query position over a layer's cache ``kc``, ``vc`` ``[B, Hkv, S,
    Dh]`` (a plain GQA read): scores in the model dtype (fp32 sums; q times
    ``Dh^-½``, a power of two), ``bias`` ``[B, 1, 1, S]`` added and the
    softmax in fp32 → ``[B, 1, H, Dh]``."""
    B, _, H, D = q.shape
    qg = (q[:, 0] * D ** -0.5).view(B, cfg.num_kv_heads, H // cfg.num_kv_heads, D)
    s = torch.matmul(qg, kc.transpose(-1, -2))                     # [B, Hkv, G, S]
    p = torch.softmax(s.float() + bias, dim=-1).to(q.dtype)
    return torch.matmul(p, vc).view(B, 1, H, D)


def _full(h: torch.Tensor, fp: Params, fi: int, kv_cache, cached: bool, valid,
          rope, bias, write_at, cfg: Qwen3NextConfig) -> torch.Tensor:
    B, T, _ = h.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps, rot = cfg.rms_norm_eps, cfg.rotary_dim
    qg, k, v = linears(h, (fp["wq"], fp["wk"], fp["wv"]))
    qg = qg.view(B, T, H, 2 * D)
    gate = qg[..., D:]
    q = _rope(zc_norm(qg[..., :D], fp["q_norm"], eps), *rope, rot)
    k = _rope(zc_norm(k.view(B, T, Hkv, D), fp["k_norm"], eps), *rope, rot)
    v = v.view(B, T, Hkv, D)
    if not cached:
        if kv_cache is not None:
            kv_cache["k"][fi, :, :, :T] = k.transpose(1, 2)
            kv_cache["v"][fi, :, :, :T] = v.transpose(1, 2)
        attn = _attend_full(q, k, v, valid, cfg)
    else:
        kc, vc = kv_cache["k"][fi], kv_cache["v"][fi]
        if isinstance(write_at, torch.Tensor):
            kc.index_copy_(2, write_at, k.transpose(1, 2))
            vc.index_copy_(2, write_at, v.transpose(1, 2))
        else:
            kc[:, :, write_at:write_at + 1] = k.transpose(1, 2)
            vc[:, :, write_at:write_at + 1] = v.transpose(1, 2)
        attn = _attend_cached(q, kc, vc, bias, cfg)
    out = (attn.float() * torch.sigmoid(gate.float())).to(h.dtype)
    return linear(out.reshape(B, T, H * D), fp["wo"])


def _moe(h: torch.Tensor, mp: Params, counts: torch.Tensor,
         cfg: Qwen3NextConfig) -> torch.Tensor:
    B, T, D = h.shape
    return moe.routed_experts(
        h.reshape(B * T, D), mp["router"], mp["w13"], mp["w2"],
        cfg.num_experts_per_tok, counts, cfg.norm_topk_prob, 1.0, cfg.n_shared,
        held=cfg.held_range, shared_gate=True).view(B, T, D)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params: Params, cfg: Qwen3NextConfig, inputs_embeds: torch.Tensor,
            attention_mask: torch.Tensor, positions: torch.Tensor,
            kv_cache: Optional[Dict[str, Any]] = None, self_attn: bool = False,
            attn_window: Optional[int] = None, **unsupported
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the trunk; returns (final-norm hidden states, cache), as
    ``llama.forward`` does.  Without a cache: causal over the inputs,
    ``attention_mask`` ``[B, T]``.  ``self_attn=True``: prefill into an
    empty cache.  A cached step (T = 1) is the module docstring's.
    ``attn_window`` is taken and not needed: the read is the cache's whole
    width."""
    given = sorted(k for k, v in unsupported.items() if v not in (None, False))
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: not ported for the GDN/MoE trunk (LoRA, remat "
            "and attn_impl belong to step 5; prefix_kv to the shared-prefix "
            "engines; cache_positions to SJD)")
    if mesh_lib.model_parallel_size() > 1:
        raise NotImplementedError("tensor parallel is not ported for the GDN/MoE "
                                  "trunk")
    x = inputs_embeds.to(cfg.dtype)
    B, T = x.shape[:2]
    cached = kv_cache is not None and not self_attn
    if kv_cache is None:
        counts = torch.zeros((cfg.n_moe, cfg.held + cfg.n_shared), dtype=torch.int32,
                             device=x.device)
        length = 0
    else:
        length = kv_cache["length"]
        if self_attn and not (isinstance(length, int) and length == 0):
            raise ValueError("self_attn prefill needs an empty cache")
        if cached and T != 1:
            raise NotImplementedError(
                "a cached step of T > 1 (step 4b's suffixes) is not ported on the "
                "GDN/MoE trunk: T = 1 only")
        counts = kv_cache["step_counts"]
        counts.zero_()
    device_len = isinstance(length, torch.Tensor)
    write_at = length.long() if device_len else length
    rope = rope_cos_sin(cfg, positions)
    valid = bias = None
    if cached:    # the positions a step reads: [0, length + 1) that the mask admits
        S = kv_cache["k"].shape[3]
        cols = torch.arange(S, device=x.device)
        ok = (attention_mask[:, :S] != 0) & (cols < length + 1)[None, :]
        bias = torch.where(ok, 0.0, NEG_FILL)[:, None, None, :]
    elif attention_mask is not None:
        valid = attention_mask != 0
    gi = fi = 0
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        h = zc_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        if cfg.is_full(li):
            x = x + _full(h, _layer(params["full"], fi), fi, kv_cache, cached, valid,
                          rope, bias, write_at, cfg)
            fi += 1
        else:
            x = x + _gdn(h, _layer(params["gdn"], gi), gi, kv_cache, cached, valid, cfg)
            gi += 1
        h = zc_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        x = x + _moe(h, _layer(params["moe"], li), counts[li], cfg)
    if kv_cache is not None:
        rows = kv_cache["expert_rows"]
        routed = counts[:, :cfg.held]
        if device_len:
            rows.index_add_(0, write_at, routed[None])
            length.add_(T)
        else:
            rows[0 if self_attn else write_at] += routed
            kv_cache["length"] = length + T
    return zc_norm(x, params["final_norm"], cfg.rms_norm_eps), kv_cache
