"""DeepSeek-V2 decoder trunk (multi-head latent attention and routed
experts) in PyTorch, the second trunk family of the Janus model beside
``models/llama.py``.  The JAX package has no counterpart.

Block (HF ``modeling_deepseek``, DeepSeek-V2-Lite): ``x += Wo · MLA(n1(x))``,
``x += FFN(n2(x))`` with RMSNorm ``n1``, ``n2``.

- MLA: ``q = Wq·h`` per head ``[q_nope (dn) ‖ q_pe (dr)]``; ``[c ‖ k_pe] =
  Wkv_a·h`` with the latent ``c`` (``kv_lora_rank`` wide) normed by
  ``kv_norm`` and one rope part ``k_pe`` shared by the heads; ``[k_nope ‖ v]
  = Wkv_b·c`` per head.  Scores ``(q_nope·k_nope + q_pe·k_pe) ·
  softmax_scale``, where ``softmax_scale = (dn + dr)^-½ · mscale²`` under
  YaRN.  ``q_lora_rank`` (a low-rank query) is not ported.
- YaRN rope on the ``dr`` rope dims: frequencies blended between ``θ^(-2i/dr)``
  and its ``1/factor`` by the linear ramp between the correction dims of
  ``beta_fast`` and ``beta_slow``; cos and sin times ``mscale(factor,
  mscale) / mscale(factor, mscale_all_dim)``.  It rotates the interleaved
  pairs ``(2i, 2i + 1)`` (one complex product) and leaves them in place;
  HF writes them de-interleaved (``view(d/2, 2).transpose``), a permutation
  of queries and keys alike, so every ``q_pe·k_pe`` is the same.  With
  ``use_nope`` (Kimi Linear's MLA layers, ``mla_use_nope``) nothing is
  rotated: ``q_pe`` and ``k_pe`` enter the scores as projected.
- FFN: the first ``first_k_dense_replace`` layers a SiLU-gated MLP; the
  rest MoE: fp32 router logits, softmax, greedy top-k, weights
  renormalised only under ``norm_topk_prob``, times
  ``routed_scaling_factor``; ``Σ wᵢ·Eᵢ(h)`` plus a shared SiLU MLP of width
  ``moe_intermediate_size · n_shared_experts``, which ``ops/moe.py`` runs as
  ``n_shared_experts`` more experts that every token takes with weight 1.

Parameters (torch layout ``[out, in]``; projections plain or int8
``{"q", "s"}``): ``layers`` stacks every layer's norms and attention
(``attn_norm``, ``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``,
``mlp_norm``); ``dense`` the dense layers' ``w_gate``, ``w_up``, ``w_down``;
``moe`` the MoE layers' ``router`` (model dtype), ``w13`` ``[Lm, E + S, 2F,
D]`` (gate rows then up rows) and ``w2`` ``[Lm, E + S, D, F]``: the E routed
experts, then the shared MLP cut into S = ``n_shared_experts`` experts
(``models/weights.py``).  ``w_uk`` ``[L, H, dn, R]`` and ``w_uv`` ``[L, H,
dv, R]`` are ``Wkv_b``'s rows by head in the model dtype (dequantized once
at load), the absorbed form's weights.

The cache is the latent one: ``ckv`` ``[L, B, S, kv_lora_rank + dr]`` in the
model dtype, ``c`` after its norm and ``k_pe`` after rope.  Prefill writes
it and attends in the plain (non-absorbed) form: keys and values expanded
by ``Wkv_b`` (the flash kernel takes head dim 128 only, these are 192 and
128).  A cached T = 1 step reads it in the absorbed form: ``q_nope·W_UKᵀ``
against ``c`` plus ``q_pe`` against ``k_pe``, then ``p·c`` and ``W_UV``.  As
for ``llama.forward``, ``length`` may be an int32 tensor in device memory,
so the step reads no host value and can be captured in a CUDA graph.

The cache also holds the MoE's counters: ``step_counts`` ``[Lm, E + S]``,
each layer's rows an expert in the current pass, and ``expert_rows`` ``[S,
Lm, E]``, the routed experts' of the prefill at row 0 and of each T = 1
step at the row it writes.

Not ported, and refused by name: ``q_lora_rank``, tensor parallel, an int8
or int4 latent cache, per-row offsets (SJD), cached T > 1 steps (step 4b's
suffixes), LoRA and the training path (step 5), the text engine.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ospo_tpu_torch.models.llama import linear, linears, rms_norm
from ospo_tpu_torch.ops import moe
from ospo_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]

NEG_FILL = -1e30


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944      # the dense layers' FFN
    moe_intermediate_size: int = 1408   # one expert's FFN
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    rope_theta: float = 10000.0
    # YaRN (rope_scaling type "yarn"); factor 1 is plain rope
    rope_factor: float = 40.0
    rope_original_max: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    rms_norm_eps: float = 1e-6
    max_seq_len: int = 163840
    dtype: Any = torch.bfloat16
    use_nope: bool = False              # no rope: the rope dims unrotated

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a (layer, position, row) of the latent cache."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def n_dense(self) -> int:
        return self.first_k_dense_replace

    @property
    def n_moe(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    # the head count and width the step-3 benchmark driver records of any
    # trunk: MLA's keys are per head, their width the nope and rope parts
    @property
    def kv_heads(self) -> int:
        return self.num_heads

    @property
    def dim_head(self) -> int:
        return self.q_head_dim

    @property
    def softmax_scale(self) -> float:
        scale = self.q_head_dim ** -0.5
        if self.rope_factor > 1 and self.rope_mscale_all_dim:
            scale *= yarn_mscale(self.rope_factor, self.rope_mscale_all_dim) ** 2
        return scale


# DeepSeek-V2-Lite (huggingface.co/deepseek-ai/DeepSeek-V2-Lite, config.json)
DEEPSEEK_V2_LITE = DeepseekV2Config()


def is_mla(cfg) -> bool:
    return isinstance(cfg, DeepseekV2Config)


# how refusals name this trunk (``janus.refuse_own_trunk``)
TRUNK = "MLA/MoE trunk (DeepSeek-V2)"


def config_from_hf(lc: dict, dtype) -> DeepseekV2Config:
    """The trunk's config from the HF ``language_config`` (``model_type``
    ``deepseek_v2``); what is not ported raises."""
    if lc.get("q_lora_rank") is not None:
        raise NotImplementedError(
            f"q_lora_rank {lc['q_lora_rank']}: the low-rank query projection "
            "of MLA is not ported (DeepSeek-V2-Lite has none)")
    for key, want in (("scoring_func", "softmax"), ("topk_method", "greedy"),
                      ("moe_layer_freq", 1)):
        if lc.get(key, want) != want:
            raise NotImplementedError(f"{key} {lc[key]!r} is not ported "
                                      f"(only {want!r})")
    rs = lc.get("rope_scaling") or {}
    if rs and rs.get("type") != "yarn":
        raise NotImplementedError(f"rope_scaling {rs.get('type')!r}: only yarn")
    return DeepseekV2Config(
        vocab_size=lc["vocab_size"], hidden_size=lc["hidden_size"],
        intermediate_size=lc["intermediate_size"],
        moe_intermediate_size=lc["moe_intermediate_size"],
        num_layers=lc["num_hidden_layers"],
        num_heads=lc["num_attention_heads"],
        kv_lora_rank=lc["kv_lora_rank"],
        qk_nope_head_dim=lc["qk_nope_head_dim"],
        qk_rope_head_dim=lc["qk_rope_head_dim"], v_head_dim=lc["v_head_dim"],
        n_routed_experts=lc["n_routed_experts"],
        n_shared_experts=lc.get("n_shared_experts") or 0,
        num_experts_per_tok=lc["num_experts_per_tok"],
        first_k_dense_replace=lc.get("first_k_dense_replace", 0),
        norm_topk_prob=bool(lc.get("norm_topk_prob", False)),
        routed_scaling_factor=float(lc.get("routed_scaling_factor", 1.0)),
        rope_theta=float(lc.get("rope_theta", 10000.0)),
        rope_factor=float(rs.get("factor", 1.0)),
        rope_original_max=int(rs.get("original_max_position_embeddings", 4096)),
        rope_beta_fast=float(rs.get("beta_fast", 32)),
        rope_beta_slow=float(rs.get("beta_slow", 1)),
        rope_mscale=float(rs.get("mscale", 1.0)),
        rope_mscale_all_dim=float(rs.get("mscale_all_dim", 0.0)),
        rms_norm_eps=lc.get("rms_norm_eps", 1e-6),
        max_seq_len=lc.get("max_position_embeddings", 163840), dtype=dtype)


def _layer(tree, li: int):
    """Layer ``li``'s slice of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return tree[li]


# ---------------------------------------------------------------------------
# YaRN rope
# ---------------------------------------------------------------------------


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(cfg: DeepseekV2Config) -> Tuple[int, int]:
    """The rope dims between which the ramp blends (10..23 for
    DeepSeek-V2-Lite)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta

    def dim_of(rotations: float) -> float:
        return (dim * math.log(cfg.rope_original_max / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = math.floor(dim_of(cfg.rope_beta_fast))
    high = math.ceil(dim_of(cfg.rope_beta_slow))
    return max(low, 0), min(high, dim - 1)


def rope_cos_sin(cfg: DeepseekV2Config, positions: torch.Tensor):
    """fp32 cos and sin ``[B, T, dr/2]`` of the positions, made on the
    device (no copy from the host, so a step can be captured)."""
    dim, dev = cfg.qk_rope_head_dim, positions.device
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim
    base_pow = torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
                                    device=dev), exponent)
    inv_freq = 1.0 / base_pow
    scale = 1.0
    if cfg.rope_factor > 1:
        low, high = yarn_correction_range(cfg)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=dev) - low)
                / (high - low)).clamp(0, 1)
        extra = 1.0 - ramp                 # weight of the unscaled frequency
        inv_freq = inv_freq / cfg.rope_factor * (1.0 - extra) + inv_freq * extra
        scale = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
                 / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles) * scale, torch.sin(angles) * scale


def rope_rotation(cfg: DeepseekV2Config, positions: torch.Tensor) -> torch.Tensor:
    """complex64 ``[B, T, dr/2]``: each pair's rotation, scaled."""
    cos, sin = rope_cos_sin(cfg, positions)
    return torch.complex(cos, sin)


def apply_rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """x ``[B, T, H, dr]``: the interleaved pairs rotated in fp32, in place
    of the pairs."""
    xc = torch.view_as_complex(x.float().contiguous().view(*x.shape[:-1], -1, 2))
    return torch.view_as_real(xc * rot[:, :, None, :]).flatten(-2).to(x.dtype)


def absorbed(wkv_b, cfg: DeepseekV2Config):
    """``Wkv_b`` ``[L, H·(dn + dv), R]`` (plain or int8 rows) → (W_UK ``[L,
    H, dn, R]``, W_UV ``[L, H, dv, R]``) in the model dtype."""
    dn, H, R = cfg.qk_nope_head_dim, cfg.num_heads, cfg.kv_lora_rank
    if isinstance(wkv_b, dict):
        w = (wkv_b["q"].float() * wkv_b["s"][..., None]).to(cfg.dtype)
    else:
        w = wkv_b
    w = w.view(w.shape[0], H, -1, R)
    return w[:, :, :dn].contiguous(), w[:, :, dn:].contiguous()


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: DeepseekV2Config, batch: int, max_len: int,
                  quantized=False, layout: str = "shbd",
                  device=None) -> Dict[str, Any]:
    """The latent cache ``ckv`` ``[L, B, S, kv_lora_rank + dr]`` in the model
    dtype and the MoE's counters (the module's docstring).  ``layout`` is
    taken for the engines' calls; the latent cache has one layout."""
    if quantized:
        raise NotImplementedError(
            f"kv_quant {quantized!r}: an int8/int4 latent cache is not ported "
            "(the MLA trunk's cache holds model-dtype latents)")
    i32 = dict(dtype=torch.int32, device=device)
    return {"ckv": torch.zeros((cfg.num_layers, batch, max_len, cfg.latent_dim),
                               dtype=cfg.dtype, device=device),
            "expert_rows": torch.zeros((max_len, cfg.n_moe, cfg.n_routed_experts), **i32),
            "step_counts": torch.zeros((cfg.n_moe, cfg.n_routed_experts
                                        + cfg.n_shared_experts), **i32),
            "length": 0, "layout": "latent"}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attend_full(q_nope, q_pe, c, k_pe, wkv_b, mask, cfg: DeepseekV2Config):
    """The plain form over the T fresh positions (prefill, no cache):
    causal, ``mask`` ``[B, T]`` key validity → ``[B, T, H·dv]``."""
    B, T, H, _ = q_nope.shape
    dn = cfg.qk_nope_head_dim
    kv = linear(c, wkv_b).view(B, T, H, dn + cfg.v_head_dim)
    k = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(B, T, H, k_pe.shape[-1])], -1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * cfg.softmax_scale
    rows = torch.arange(T, device=q.device)
    allowed = (rows[None, :] <= rows[:, None])[None, None]
    if mask is not None:
        allowed = allowed & (mask[:, None, None, :] != 0)
    s = torch.where(allowed, s, torch.full_like(s, NEG_FILL))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, kv[..., dn:].float())
    return out.to(q_nope.dtype).reshape(B, T, H * cfg.v_head_dim)


def _attend_latent(q_nope, q_pe, ckv, w_uk, w_uv, bias, cfg: DeepseekV2Config):
    """The absorbed form of one query position over a layer's latent cache
    ``ckv`` ``[B, S, R + dr]``; ``bias`` ``[B, 1, S]`` is 0 where a position
    is read and ``NEG_FILL`` elsewhere.  Scores in the model dtype (fp32
    sums), the softmax in fp32 → ``[B, 1, H·dv]``."""
    B, _, H, _ = q_nope.shape
    q_abs = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk)        # [H, B, R]
    q_cat = torch.cat([q_abs.transpose(0, 1), q_pe[:, 0]], dim=-1)  # [B, H, R+dr]
    s = torch.baddbmm(bias, q_cat, ckv.transpose(1, 2), alpha=cfg.softmax_scale)
    p = torch.softmax(s, dim=-1, dtype=torch.float32).to(q_nope.dtype)
    lat = torch.bmm(p, ckv)[..., :cfg.kv_lora_rank]              # [B, H, R]
    v = torch.bmm(lat.transpose(0, 1), w_uv.transpose(1, 2))     # [H, B, dv]
    return v.transpose(0, 1).reshape(B, 1, H * cfg.v_head_dim)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def _mlp(h: torch.Tensor, w: Params) -> torch.Tensor:
    gate, up = linears(h, (w["w_gate"], w["w_up"]))
    act = F.silu(gate.float()).to(h.dtype) * up
    return linear(act, w["w_down"])


def _moe(h: torch.Tensor, mp: Params, counts: torch.Tensor,
         cfg: DeepseekV2Config) -> torch.Tensor:
    B, T, D = h.shape
    return moe.routed_experts(
        h.reshape(B * T, D), mp["router"], mp["w13"], mp["w2"],
        cfg.num_experts_per_tok, counts, cfg.norm_topk_prob,
        cfg.routed_scaling_factor, cfg.n_shared_experts).view(B, T, D)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params: Params, cfg: DeepseekV2Config, inputs_embeds: torch.Tensor,
            attention_mask: torch.Tensor, positions: torch.Tensor,
            kv_cache: Optional[Dict[str, Any]] = None, self_attn: bool = False,
            attn_window: Optional[int] = None, **unsupported
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the trunk; returns (final-norm hidden states, cache), as
    ``llama.forward`` does.  Without a cache: causal over the inputs,
    ``attention_mask`` ``[B, T]``.  ``self_attn=True``: prefill into an
    empty latent cache.  A cached step (T = 1) writes its latent row at
    ``cache['length']`` (a host int, or an int32 tensor ``[1]`` in device
    memory that the step advances) and reads ``[0, length + 1)`` of the
    window ``attention_mask`` ``[B, S]`` admits.  ``attn_window`` is taken
    and not needed: the read is the cache's whole width."""
    given = sorted(k for k, v in unsupported.items() if v not in (None, False))
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: not ported for the MLA/MoE trunk "
            "(LoRA, remat and attn_impl belong to step 5; prefix_kv to the "
            "shared-prefix engines; cache_positions to SJD)")
    if mesh_lib.model_parallel_size() > 1:
        raise NotImplementedError("tensor parallel is not ported for the "
                                  "MLA/MoE trunk")
    x = inputs_embeds.to(cfg.dtype)
    T = x.shape[1]
    rot = None if cfg.use_nope else rope_rotation(cfg, positions)
    cached = kv_cache is not None and not self_attn
    if kv_cache is None:
        counts = torch.zeros((cfg.n_moe, cfg.n_routed_experts + cfg.n_shared_experts),
                             dtype=torch.int32, device=x.device)
        length = 0
    else:
        length = kv_cache["length"]
        if self_attn and not (isinstance(length, int) and length == 0):
            raise ValueError("self_attn prefill needs an empty cache")
        if cached and T != 1:
            raise NotImplementedError(
                "a cached step of T > 1 (step 4b's suffixes) is not ported on "
                "the latent cache: T = 1 only")
        counts = kv_cache["step_counts"]
        counts.zero_()
    write_at = length.long() if isinstance(length, torch.Tensor) else length
    bias = step_bias(attention_mask, kv_cache, cfg) if cached else None
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        x = x + mla(h, lp, li, kv_cache, cached, attention_mask, rot, bias, write_at, cfg)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        if li < cfg.n_dense:
            x = x + _mlp(h, _layer(params["dense"], li))
        else:
            m = li - cfg.n_dense
            x = x + _moe(h, _layer(params["moe"], m), counts[m], cfg)
    if kv_cache is not None:
        advance(kv_cache, counts[:, :cfg.n_routed_experts], self_attn, write_at, T)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), kv_cache


def step_bias(attention_mask: torch.Tensor, kv_cache, cfg: DeepseekV2Config):
    """A cached step's read of the latent cache: 0 over ``[0, length + 1)``
    where ``attention_mask`` admits a position, ``NEG_FILL`` elsewhere →
    ``[B, 1, S]`` in the model dtype."""
    S = kv_cache["ckv"].shape[2]
    cols = torch.arange(S, device=attention_mask.device)
    valid = (attention_mask[:, :S] != 0) & (cols < kv_cache["length"] + 1)[None, :]
    return torch.where(valid, 0.0, NEG_FILL).to(cfg.dtype)[:, None, :]


def advance(kv_cache, routed: torch.Tensor, self_attn: bool, write_at, T: int) -> None:
    """After a pass: the routed experts' rows ``routed`` ``[Lm, E]`` added to
    ``expert_rows`` (the prefill's at row 0, a step's at the row it wrote)
    and the cache's length advanced by T (in place where it is a device
    tensor)."""
    rows, length = kv_cache["expert_rows"], kv_cache["length"]
    if isinstance(length, torch.Tensor):
        rows.index_add_(0, write_at, routed[None])
        length.add_(T)
    else:
        rows[0 if self_attn else write_at] += routed
        kv_cache["length"] = length + T


def mla(h: torch.Tensor, lp: Params, li: int, kv_cache, cached: bool, mask, rot, bias,
        write_at, cfg: DeepseekV2Config) -> torch.Tensor:
    """Layer ``li``'s MLA mixer over ``h`` ``[B, T, D]`` through ``Wo`` →
    ``[B, T, D]``: without a cached step the plain form over the T
    positions (the prefill writes its latent rows into an empty cache), a
    cached T = 1 step the absorbed read after writing its row at
    ``write_at``; ``rot`` the rope rotation (None under ``use_nope``),
    ``bias`` :func:`step_bias`'s.  ``lp`` holds ``wq``, ``wkv_a``,
    ``kv_norm``, ``wkv_b``, ``wo`` and the absorbed ``w_uk``, ``w_uv``."""
    B, T = h.shape[:2]
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    R = cfg.kv_lora_rank
    q, ckv = linears(h, (lp["wq"], lp["wkv_a"]))
    q = q.view(B, T, H, dn + dr)
    c = rms_norm(ckv[..., :R], lp["kv_norm"], cfg.rms_norm_eps)
    if rot is None:
        q_pe, k_pe = q[..., dn:], ckv[..., R:]
    else:
        q_pe = apply_rope(q[..., dn:], rot)
        k_pe = apply_rope(ckv[..., None, R:], rot)[:, :, 0]
    if not cached:
        if kv_cache is not None:
            kv_cache["ckv"][li, :, :T] = torch.cat([c, k_pe], dim=-1)
        attn = _attend_full(q[..., :dn], q_pe, c, k_pe, lp["wkv_b"], mask, cfg)
    else:
        row = torch.cat([c, k_pe], dim=-1)                  # [B, 1, R+dr]
        layer_cache = kv_cache["ckv"][li]
        if isinstance(write_at, torch.Tensor):
            layer_cache.index_copy_(1, write_at, row)
        else:
            layer_cache[:, write_at:write_at + 1] = row
        attn = _attend_latent(q[..., :dn], q_pe, layer_cache, lp["w_uk"], lp["w_uv"],
                              bias, cfg)
    return linear(attn, lp["wo"])


def expert_counters(rows, t_prompt: int, n_img: int, slots: int = 0) -> Dict[str, int]:
    """A call's MoE counters from its ``expert_rows`` (host array ``[S,
    Lm, E]``): over the cached steps (rows ``[t_prompt, t_prompt + n_img -
    1)``) the routed rows, the sum over steps and layers of the busiest
    expert's rows, the expert slots (experts × layers × steps) and those
    with no row; the prefill's routed rows and busiest rows (row 0).  An
    expert share's layers route ``slots`` slots a step and layer (every
    row's top-k): those that land on experts it does not hold are
    ``absent_slots``."""
    steps = rows[t_prompt:t_prompt + n_img - 1]
    pre = rows[0]
    out = {"steps": int(steps.shape[0]),
           "routed_rows": int(steps.sum()),
           "busiest_rows": int(steps.max(axis=-1).sum()),
           "expert_slots": int(steps.size),
           "idle_experts": int((steps == 0).sum()),
           "prefill_routed_rows": int(pre.sum()),
           "prefill_busiest_rows": int(pre.max(axis=-1).sum())}
    if slots:
        out["absent_slots"] = slots * steps.shape[0] * steps.shape[1] - out["routed_rows"]
    return out
