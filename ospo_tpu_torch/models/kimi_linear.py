"""Kimi Linear decoder trunk (Kimi Delta Attention beside NoPE latent
attention, sigmoid-routed experts with a shared expert) in PyTorch, the
fourth trunk family of the Janus model beside ``models/llama.py``,
``models/deepseek_v2.py`` and ``models/qwen3_next.py``.  The JAX package
has no counterpart.

Block (the release's ``modeling_kimi``, Kimi-Linear-48B-A3B): ``x +=
mixer(n1(x))``, ``x += FFN(n2(x))`` with plain RMSNorms ``x / rms(x) · w``
(eps ``rms_norm_eps``).  ``linear_attn_config`` lists the layers of each
mixer, 1-indexed: ``kda_layers`` run Kimi Delta Attention (KDA),
``full_attn_layers`` MLA.

- KDA (``ops/gated_delta.py`` defines the step): q, k, v by three
  projections of ``H·D``, each through its own causal depthwise conv of
  width ``short_conv_kernel_size`` and SiLU; q and k L2-normalised, q times
  ``D^-½``; the decay ``g = −exp(A_log[h])·softplus(f_b(f_a(x)) +
  dt_bias)``, a vector over the head's key rows; ``β = sigmoid(b(x))``; the
  delta rule over a ``[Dk, Dv]`` state a head, each key row decayed by its
  own factor; ``rms(o)·w·sigmoid(g_b(g_a(x)))`` (``o_norm``), ``o_proj``.
- MLA: ``deepseek_v2.mla`` with ``use_nope`` (``mla_use_nope``): the
  ``qk_rope_head_dim`` dims stay in q and in the shared ``k_pe`` and enter
  the scores unrotated, at ``(dn + dr)^-½``; no ``q_lora_rank``.
- FFN: the first ``first_k_dense_replace`` layers a SiLU MLP; the rest
  ``ops/moe.py``'s experts with sigmoid routing (``moe_router_activation_func``
  sigmoid, the top-k over score + ``e_score_correction_bias``, the unbiased
  scores renormalised under ``moe_renormalize``, times
  ``routed_scaling_factor``) and ``num_shared_experts`` shared experts of
  weight 1.  ``use_grouped_topk`` at one group is the plain top-k.  An
  expert share holds the routed experts ``[first_held, first_held + held)``.

Parameters (torch layout ``[out, in]``; projections plain or int8 ``{"q",
"s"}``): ``layers`` every layer's ``attn_norm`` and ``mlp_norm``; ``kda``
the KDA layers' ``wq``, ``wk``, ``wv``, ``f_a``, ``f_b``, ``g_a``, ``g_b``,
``wb``, ``wo``, ``conv_w`` ``[3·H·D, K]`` (q's, k's, then v's channels,
model dtype), ``A_log`` ``[H]``, ``dt_bias`` ``[H·D]`` and ``norm``
``[D]`` (fp32); ``mla`` the MLA layers' ``deepseek_v2`` tree (``wq``,
``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``, ``w_uk``, ``w_uv``); ``dense``
the dense layers' ``w_gate``, ``w_up``, ``w_down``; ``moe`` the MoE
layers' ``router`` ``[Lm, E, D]`` (model dtype), ``bias`` ``[Lm, E]``
(fp32), ``w13`` and ``w2`` (the held experts, then the shared ones).

The cache holds two kinds of state: the MLA layers' latent cache ``ckv``
``[Lmla, B, S, kv_lora_rank + dr]`` (model dtype), which grows by a
position a step, and the KDA layers' ``kda_state`` ``[Lkda, B, H, Dk, Dv]``
(fp32) and ``conv_state`` ``[Lkda, B, K - 1, 3·H·D]`` (model dtype),
overwritten in place every step.  A prefill runs the KDA step a position at
a time from zeroed states and writes the latent rows; a cached T = 1 step's
``length`` may be an int32 tensor ``[1]`` in device memory, so the step can
be captured in a CUDA graph.  The MoE's counters are ``deepseek_v2``'s.

Not ported, and refused by name: ``q_lora_rank``, the output gate of MLA
(``mla_use_output_gate``), tensor parallel, an int8 or int4 cache,
per-row offsets (SJD), cached T > 1 steps (step 4b's suffixes), LoRA and
the training path (step 5), the text engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ospo_tpu_torch.models import deepseek_v2
from ospo_tpu_torch.models.llama import linear, linears, rms_norm
from ospo_tpu_torch.ops import gated_delta, moe
from ospo_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig:
    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216       # the dense layers' FFN
    num_layers: int = 27
    kda_layers: Tuple[int, ...] = ()   # 0-indexed
    num_heads: int = 32                 # MLA heads
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kda_heads: int = 32
    kda_head_dim: int = 128
    conv_kernel: int = 4
    experts: int = 256                  # routed experts the router scores
    held: int = 256                     # routed experts this layer holds
    first_held: int = 0
    moe_intermediate_size: int = 1024
    n_shared: int = 1
    num_experts_per_tok: int = 8
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.446
    first_k_dense_replace: int = 1
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 1048576
    dtype: Any = torch.bfloat16

    def is_kda(self, li: int) -> bool:
        return li in self.kda_layers

    @property
    def n_kda(self) -> int:
        return len(self.kda_layers)

    @property
    def n_mla(self) -> int:
        return self.num_layers - self.n_kda

    @property
    def n_dense(self) -> int:
        return self.first_k_dense_replace

    @property
    def n_moe(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @property
    def held_range(self) -> Tuple[int, int]:
        return self.first_held, self.held

    @property
    def mla(self) -> deepseek_v2.DeepseekV2Config:
        """The MLA layers' config: rope off, no YaRN."""
        return deepseek_v2.DeepseekV2Config(
            hidden_size=self.hidden_size, num_heads=self.num_heads,
            kv_lora_rank=self.kv_lora_rank, qk_nope_head_dim=self.qk_nope_head_dim,
            qk_rope_head_dim=self.qk_rope_head_dim, v_head_dim=self.v_head_dim,
            rope_factor=1.0, rms_norm_eps=self.rms_norm_eps, dtype=self.dtype,
            use_nope=True)

    # the head count and width the step-3 benchmark driver records of any
    # trunk: MLA's keys are per head, their width the nope and rope parts
    @property
    def kv_heads(self) -> int:
        return self.num_heads

    @property
    def dim_head(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def kda_width(self) -> int:
        return self.kda_heads * self.kda_head_dim

    def state_bytes(self, rows: int) -> int:
        """Bytes of the KDA layers' recurrent and conv states of ``rows`` rows."""
        rec = self.kda_heads * self.kda_head_dim ** 2 * 4
        conv = (self.conv_kernel - 1) * 3 * self.kda_width * torch.finfo(self.dtype).bits // 8
        return self.n_kda * rows * (rec + conv)


def is_kimi(cfg) -> bool:
    return isinstance(cfg, KimiLinearConfig)


# how refusals name this trunk (``janus.refuse_own_trunk``)
TRUNK = "KDA/MLA/MoE trunk (Kimi Linear)"


def config_from_hf(lc: dict, dtype) -> KimiLinearConfig:
    """The trunk's config from the HF ``language_config`` (``model_type``
    ``kimi_linear``).  ``num_experts`` counts the experts held here; an
    ``expert_parallel`` entry (``experts``, the router's width, and
    ``first_held``) states the share, and without one every expert is
    held.  What is not ported raises."""
    for key, want in (("q_lora_rank", None), ("mla_use_nope", True),
                      ("mla_use_output_gate", False), ("hidden_act", "silu"),
                      ("moe_router_activation_func", "sigmoid"), ("moe_layer_freq", 1),
                      ("num_expert_group", 1), ("topk_group", 1), ("rope_scaling", None)):
        if lc.get(key, want) != want:
            raise NotImplementedError(f"{key} {lc[key]!r} is not ported (only {want!r})")
    la = lc["linear_attn_config"]
    n = lc["num_hidden_layers"]
    kda = sorted(i - 1 for i in la["kda_layers"])
    full = sorted(i - 1 for i in la["full_attn_layers"])
    if sorted(kda + full) != list(range(n)):
        raise ValueError(f"kda_layers {la['kda_layers']} and full_attn_layers "
                         f"{la['full_attn_layers']} must list each of the {n} layers once "
                         "(1-indexed)")
    ep = lc.get("expert_parallel") or {}
    held = lc["num_experts"]
    return KimiLinearConfig(
        vocab_size=lc["vocab_size"], hidden_size=lc["hidden_size"],
        intermediate_size=lc["intermediate_size"], num_layers=n,
        kda_layers=tuple(kda), num_heads=lc["num_attention_heads"],
        kv_lora_rank=lc["kv_lora_rank"], qk_nope_head_dim=lc["qk_nope_head_dim"],
        qk_rope_head_dim=lc["qk_rope_head_dim"], v_head_dim=lc["v_head_dim"],
        kda_heads=la["num_heads"], kda_head_dim=la["head_dim"],
        conv_kernel=la["short_conv_kernel_size"],
        experts=int(ep.get("experts", held)), held=held,
        first_held=int(ep.get("first_held", 0)),
        moe_intermediate_size=lc["moe_intermediate_size"],
        n_shared=lc.get("num_shared_experts", 0),
        num_experts_per_tok=lc["num_experts_per_token"],
        norm_topk_prob=bool(lc.get("moe_renormalize", False)),
        routed_scaling_factor=float(lc.get("routed_scaling_factor", 1.0)),
        first_k_dense_replace=lc.get("first_k_dense_replace", 0),
        rms_norm_eps=lc.get("rms_norm_eps", 1e-5),
        max_seq_len=lc.get("model_max_length", 1048576), dtype=dtype)


_layer = deepseek_v2._layer


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: KimiLinearConfig, batch: int, max_len: int,
                  quantized=False, layout: str = "shbd",
                  device=None) -> Dict[str, Any]:
    """The cache of the module's docstring, zeroed.  ``layout`` is taken for
    the engines' calls; this cache has one layout."""
    if quantized:
        raise NotImplementedError(
            f"kv_quant {quantized!r}: an int8/int4 latent cache is not ported for "
            f"the {TRUNK}")
    dt = dict(dtype=cfg.dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    D = cfg.kda_head_dim
    return {"ckv": torch.zeros((cfg.n_mla, batch, max_len,
                                cfg.kv_lora_rank + cfg.qk_rope_head_dim), **dt),
            "kda_state": torch.zeros((cfg.n_kda, batch, cfg.kda_heads, D, D),
                                     dtype=torch.float32, device=device),
            "conv_state": torch.zeros((cfg.n_kda, batch, cfg.conv_kernel - 1,
                                       3 * cfg.kda_width), **dt),
            "expert_rows": torch.zeros((max_len, cfg.n_moe, cfg.held), **i32),
            "step_counts": torch.zeros((cfg.n_moe, cfg.held + cfg.n_shared), **i32),
            "length": 0, "layout": "hybrid"}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _kda(h: torch.Tensor, kp: Params, ki: int, kv_cache, cached: bool, valid,
         cfg: KimiLinearConfig) -> torch.Tensor:
    B, T, _ = h.shape
    q, k, v = linears(h, (kp["wq"], kp["wk"], kp["wv"]))
    fa, ga, b = linears(h, (kp["f_a"], kp["g_a"], kp["wb"]))
    f, og = linear(fa, kp["f_b"]), linear(ga, kp["g_b"])
    args = (kp["A_log"], kp["dt_bias"], kp["norm"], cfg.kda_heads, cfg.rms_norm_eps)
    if kv_cache is None:
        D = cfg.kda_head_dim
        conv = torch.zeros((B, cfg.conv_kernel - 1, 3 * cfg.kda_width), dtype=h.dtype,
                           device=h.device)
        state = torch.zeros((B, cfg.kda_heads, D, D), dtype=torch.float32, device=h.device)
    else:
        conv, state = kv_cache["conv_state"][ki], kv_cache["kda_state"][ki]
    if cached:
        out = gated_delta.kda_decode(q[:, 0], k[:, 0], v[:, 0], f[:, 0], b[:, 0], og[:, 0],
                                     kp["conv_w"], conv, state, *args)[:, None]
    else:
        out = gated_delta.kda_prefill(q, k, v, f, b, og, valid, kp["conv_w"], conv, state,
                                      *args)
    return linear(out, kp["wo"])


def _moe(h: torch.Tensor, mp: Params, counts: torch.Tensor,
         cfg: KimiLinearConfig) -> torch.Tensor:
    B, T, D = h.shape
    return moe.routed_experts(
        h.reshape(B * T, D), mp["router"], mp["w13"], mp["w2"], cfg.num_experts_per_tok,
        counts, cfg.norm_topk_prob, cfg.routed_scaling_factor, cfg.n_shared,
        held=cfg.held_range, score_bias=mp["bias"]).view(B, T, D)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params: Params, cfg: KimiLinearConfig, inputs_embeds: torch.Tensor,
            attention_mask: torch.Tensor, positions: torch.Tensor,
            kv_cache: Optional[Dict[str, Any]] = None, self_attn: bool = False,
            attn_window: Optional[int] = None, **unsupported
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the trunk; returns (final-norm hidden states, cache), as
    ``llama.forward`` does.  Without a cache: causal over the inputs,
    ``attention_mask`` ``[B, T]``.  ``self_attn=True``: prefill into an
    empty cache.  A cached step (T = 1) is the module docstring's.
    ``positions`` are taken and not needed (no rope); ``attn_window``
    likewise: the read is the cache's whole width."""
    given = sorted(k for k, v in unsupported.items() if v not in (None, False))
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: not ported for the {TRUNK} (LoRA, remat and "
            "attn_impl belong to step 5; prefix_kv to the shared-prefix engines; "
            "cache_positions to SJD)")
    if mesh_lib.model_parallel_size() > 1:
        raise NotImplementedError(f"tensor parallel is not ported for the {TRUNK}")
    x = inputs_embeds.to(cfg.dtype)
    T = x.shape[1]
    mla_cfg = cfg.mla
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
                f"a cached step of T > 1 (step 4b's suffixes) is not ported on the "
                f"{TRUNK}: T = 1 only")
        counts = kv_cache["step_counts"]
        counts.zero_()
    write_at = length.long() if isinstance(length, torch.Tensor) else length
    bias = deepseek_v2.step_bias(attention_mask, kv_cache, mla_cfg) if cached else None
    valid = attention_mask != 0 if not cached and attention_mask is not None else None
    ki = mi = 0
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        if cfg.is_kda(li):
            x = x + _kda(h, _layer(params["kda"], ki), ki, kv_cache, cached, valid, cfg)
            ki += 1
        else:
            x = x + deepseek_v2.mla(h, _layer(params["mla"], mi), mi, kv_cache, cached,
                                    attention_mask, None, bias, write_at, mla_cfg)
            mi += 1
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        if li < cfg.n_dense:
            x = x + deepseek_v2._mlp(h, _layer(params["dense"], li))
        else:
            m = li - cfg.n_dense
            x = x + _moe(h, _layer(params["moe"], m), counts[m], cfg)
    if kv_cache is not None:
        deepseek_v2.advance(kv_cache, counts[:, :cfg.held], self_attn, write_at, T)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), kv_cache
