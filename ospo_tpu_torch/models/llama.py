"""Llama-architecture decoder (the Janus-Pro language model) in PyTorch —
counterpart of ``ospo_tpu/models/llama.py``.

Parameters are a plain dict shaped like the JAX package's tree: per-layer
weights stacked on a leading layer axis in torch layout ``[out, in]``, each
projection either a tensor or a quantized dict (int8 ``{"q", "s"}``, int4
``{"q4", "s"}`` or ``{"q4", "gs"}``; ``ops/quant.py``).  The layer loop is a
Python loop over the stack.

The KV cache is preallocated (by default in the batch-minor ``shbd``
layout ``[L, S, H, B, Dh]``; ``bshd`` and ``bhsd``, int8 and int4 payloads
too) and updated in place (PyTorch tensors are mutable; the JAX package
threads a new cache through its scan instead).  Prefill
(``self_attn=True``) writes the prompt rows and attends over them with the
flash kernel; on an ``shbd`` model-dtype or int8 cache a cached T=1 step
writes its row and reads the cache with the decode-attention kernel, and on
the card a cached T > 1 step (step 4b's question suffixes, with or without a
prefix) with the suffix-attention kernel.  With a batch-shared prefix
segment (``prefix_kv``, the text engine's shared-prefix decode and step 4b's
pre-image segment) prefill and T = 1 take the plain prefix forms of
``ops/attention.py`` instead.  Every other cached read (other layouts, int4
caches, per-row offsets, the CPU) goes through the plain
``xla_attention``.  Numerics
follow the reference: weights in the model dtype, RMSNorm / RoPE / softmax
/ SiLU in fp32; on the card a cached step over the ``shbd`` cache runs the
norms, rope with the cache write and SiLU·up as three hand-written kernels
with the same roundings (``ops/layer_tail.py``).

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

from ospo_tpu_torch.ops import layer_tail
from ospo_tpu_torch.ops.attention import (HEAD_AXIS, POS_AXIS, attention,
                                          prefix_decode_attention,
                                          xla_attention)
from ospo_tpu_torch.ops.decode_attention import decode_attention
from ospo_tpu_torch.ops.int4_matmul import int4_matmul_decode
from ospo_tpu_torch.ops.layer_tail import apply_rope, quantize_rows, rms_norm
from ospo_tpu_torch.ops.quant import (_pack_halves, quantized_matmul,
                                      quantized_matmul_int4,
                                      quantized_matmul_int4_group,
                                      quantized_matmul_w8a8, quantized_matmuls,
                                      weight_only_int8)
from ospo_tpu_torch.ops.suffix_attention import (suffix_attention,
                                                 suffix_attention_takes)
from ospo_tpu_torch.parallel import mesh as mesh_lib

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


def _out_rows(w) -> int:
    """Output rows of a stacked projection, plain or quantized."""
    if isinstance(w, dict):
        return 2 * w["q4"].shape[-2] if "q4" in w else w["q"].shape[-2]
    return w.shape[-2]


def local_config(cfg: LlamaConfig, params: Params) -> LlamaConfig:
    """``cfg`` with the head counts this process's weights hold: ``cfg``
    itself for a whole trunk, and for a tensor-parallel shard
    (``parallel/mesh.py``) its share of the heads, with the head dim pinned
    (``dim_head`` is ``hidden_size // num_heads`` otherwise)."""
    heads = _out_rows(params["layers"]["wq"]) // cfg.dim_head
    if heads == cfg.num_heads:
        return cfg
    return dataclasses.replace(
        cfg, num_heads=heads,
        num_kv_heads=_out_rows(params["layers"]["wk"]) // cfg.dim_head,
        head_dim=cfg.dim_head)


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


def rope_frequencies(cfg: LlamaConfig, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables for the given positions ([B, T] → [B, T, Dh/2]).
    Every tensor is made on the device (no copy from the host), so a step
    can be captured in a CUDA graph."""
    dh = cfg.dim_head
    exponent = torch.arange(0, dh, 2, dtype=torch.float32,
                            device=positions.device) / dh
    inv_freq = 1.0 / torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
                                          device=positions.device), exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def linear(x: torch.Tensor, w, row_parallel: bool = False) -> torch.Tensor:
    """y = x @ wᵀ for a plain weight or a quantized dict: int8 ``{"q", "s"}``,
    w8a8 ``{"q", "sa"}``, int4 ``{"q4", "s"}`` (int4 and int4n) or int4
    groups ``{"q4", "gs"}``.  A w8a8 weight runs the int8 × int8 product,
    or the weight-only one under ``quant.w8a16_override()``
    (``ospo_tpu/models/llama.py:196-206``).  A T == 1 int4 product runs the
    decode-matmul kernel (its plain version on the CPU); a longer one the
    prefill forms of ``ops/quant.py``.  ``row_parallel``: x holds this
    rank's columns of each row (tensor parallel), so w8a8's per-token scale
    takes the abs-max over the model group."""
    if not isinstance(w, dict):
        return x @ w.T
    int8 = weight_only_int8(w)
    if int8 is not None:
        return quantized_matmul(x, int8)
    if "sa" in w:
        return quantized_matmul_w8a8(
            x, w, mesh_lib.all_max_model if row_parallel else None)
    if x.shape[1] == 1:
        return int4_matmul_decode(x, w)
    if "gs" in w:
        return quantized_matmul_int4_group(x, w)
    return quantized_matmul_int4(x, w)


def linears(x: torch.Tensor, ws) -> list:
    """:func:`linear` of each column-parallel weight on one x.  Where all are
    weight-only int8 products (``quant.weight_only_int8``) they go through
    ``quant.quantized_matmuls``, which runs those of a T == 1 step on the
    card in shared launches."""
    int8 = [weight_only_int8(w) for w in ws]
    if all(w is not None for w in int8):
        return quantized_matmuls(x, int8)
    return [linear(x, w) for w in ws]


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
                dropout_seed: Optional[int] = None,
                row_parallel: bool = False) -> torch.Tensor:
    """y = x @ wᵀ (+ scaling * (x_l @ A) @ B when an adapter exists), as in
    ``ospo_tpu/models/llama.py:163-224``: A [d_in, r] and B [r, d_out] are
    cast to x's dtype; dropout (peft semantics) applies to the adapter
    input only.  The mask is drawn from a generator seeded with
    ``fold_seed(dropout_seed, PROJ_INDEX[name])`` each call, so a
    checkpointed layer's recompute redraws the same mask.

    ``row_parallel``: x holds this rank's columns of each row (tensor
    parallel), so the mask is this rank's columns of the whole row's mask,
    the one a single process draws; a column-parallel input is the whole
    row on every rank and draws that mask itself."""
    y = linear(x, w, row_parallel)
    if lora is None or name not in lora:
        return y
    a, b = lora[name]["a"], lora[name]["b"]
    x_l = x
    if dropout_rate and dropout_seed is not None:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(fold_seed(dropout_seed, PROJ_INDEX[name]))
        n, k, mp = x.shape[-1], 0, 1
        if row_parallel:
            k, mp = mesh_lib.model_rank(), mesh_lib.model_parallel_size()
        keep = x.new_empty((*x.shape[:-1], n * mp)).bernoulli_(
            1.0 - dropout_rate, generator=gen)[..., k * n:(k + 1) * n]
        x_l = x * keep / (1.0 - dropout_rate)
    return y + scaling * ((x_l @ a.to(x.dtype)) @ b.to(x.dtype))


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  quantized=False, layout: str = "shbd",
                  device=None) -> Dict[str, Any]:
    """Preallocated cache (``ospo_tpu/models/llama.py:232-286``) in one of
    three layouts: batch-minor ``shbd`` ``[L, S, H, B, Dh]`` (the default:
    the decode-attention kernel's layout), position-major ``bshd``
    ``[L, B, S, H, Dh]`` or head-major ``bhsd`` ``[L, B, H, S, Dh]``.  The
    payload is the model dtype, int8 (``quantized=True``/``"int8"``) or
    int4 (``"int4"``: two heads a byte, head axis ``H/2``, MHA only), the
    quantized ones with fp32 scales ``[L, S, H, B]`` (``shbd``) or
    ``[L, B, H, S]``.  ``length`` is a host integer (a caller may replace it
    by a device one, :func:`forward`); ``layout`` names the layout for every
    forward that touches the cache."""
    if layout not in ("bshd", "bhsd", "shbd"):
        raise ValueError(f"kv_layout {layout!r}: expected bshd | bhsd | shbd")
    if quantized not in (False, True, "int8", "int4"):
        raise ValueError(f"kv_quant {quantized!r}: expected False, True, "
                         "'int8' or 'int4'")
    L, H, D = cfg.num_layers, cfg.kv_heads, cfg.dim_head
    int4 = quantized == "int4"
    if int4 and H % 2:
        raise ValueError("int4 KV packs head pairs (even head count)")
    hp = H // 2 if int4 else H
    shape = {"bshd": (L, batch, max_len, hp, D),
             "bhsd": (L, batch, hp, max_len, D),
             "shbd": (L, max_len, hp, batch, D)}[layout]
    out: Dict[str, Any] = {"length": 0, "layout": layout}
    if quantized:
        sshape = (L, max_len, H, batch) if layout == "shbd" else (L, batch, H, max_len)
        for name in ("k", "v"):
            out[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            out[name + "_s"] = torch.zeros(sshape, dtype=torch.float32,
                                           device=device)
        return out
    out["k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    out["v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return out


def _quantize_rows_int4(x: torch.Tensor):
    """[..., H, Dh] → (packed int8 [..., H/2, Dh], fp32 scales [..., H])
    (``llama.py:297-316``): 15-level symmetric per (row, head), head j in
    the low nibble and head j + H/2 in the high nibble of head slot j."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(1e-12) / 7.0
    q = torch.round(xf / s[..., None]).clamp(-7, 7).to(torch.int8)
    if q.shape[-2] % 2:
        raise ValueError("int4 KV packs head pairs — needs an even head count")
    return _pack_halves(q), s


def _int4_cache(cache: Dict[str, Any]) -> bool:
    """Head-pair packed: the payload holds half the heads of the scales
    (whose head axis is 2 in every layout)."""
    layout = cache.get("layout", "shbd")
    return "k_s" in cache and cache["k_s"].shape[2] != cache["k"].shape[
        HEAD_AXIS[layout] + 1]


# fresh rows [B, T, H, Dh] → a layout's row order, and scales [B, T, H] →
# its scale order
_ROW_PERM = {"bshd": (0, 1, 2, 3), "bhsd": (0, 2, 1, 3), "shbd": (1, 2, 0, 3)}
_SCALE_PERM = {"bshd": (0, 2, 1), "bhsd": (0, 2, 1), "shbd": (1, 2, 0)}


def _write_kv(cache: Dict[str, Any], li: int, start,
              k: torch.Tensor, v: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> None:
    """Write fresh [B, T, H, Dh] rows at positions [start, start + T), or at
    ``[positions[b], positions[b] + T)`` per row (``llama.py:475-526``).
    ``start`` is a host integer, or (``shbd``, T = 1) an int64 tensor
    ``[1]`` holding the position in device memory.  A quantized cache
    stores the rows' int8 or int4 values (quantized in head order, then
    permuted) and their scales."""
    layout = cache.get("layout", "shbd")
    T = k.shape[1]
    int4 = _int4_cache(cache)
    at_device = isinstance(start, torch.Tensor)
    if at_device and (layout != "shbd" or T != 1 or positions is not None):
        raise ValueError("a device write position takes one row of an shbd "
                         "cache")
    for name, x in (("k", k), ("v", v)):
        if "k_s" in cache:
            xq, xs = _quantize_rows_int4(x) if int4 else quantize_rows(x)
            rows = [(name, xq.permute(_ROW_PERM[layout])),
                    (name + "_s", xs.permute(_SCALE_PERM[layout]))]
        else:
            rows = [(name, x.permute(_ROW_PERM[layout]).to(cache[name].dtype))]
        for key, val in rows:
            dst = cache[key]
            if at_device:   # along S, the axis after the layer's
                dst[li].index_copy_(0, start, val)
                continue
            if positions is None:
                if layout == "shbd":
                    dst[li, start:start + T] = val
                elif layout == "bshd" and key in ("k", "v"):
                    dst[li, :, start:start + T] = val
                else:  # bhsd rows, and the [B, H, S] scales of both
                    dst[li, :, :, start:start + T] = val
                continue
            B, dev = k.shape[0], k.device
            sidx = positions[:, None] + torch.arange(T, device=dev)[None, :]
            if layout == "bshd" and key in ("k", "v"):
                dst[li, torch.arange(B, device=dev)[:, None], sidx] = val
            else:  # [B, H, T(, Dh)] at [b, h, positions[b] + t]
                dst[li, torch.arange(B, device=dev)[:, None, None],
                    torch.arange(val.shape[1], device=dev)[None, :, None],
                    sidx[:, None, :]] = val


def _cache_window(cache: Dict[str, Any], li: int, layout: str,
                  window: Optional[int]):
    """Layer ``li``'s k and v, truncated to the first ``window`` positions,
    as :func:`~ospo_tpu_torch.ops.attention.xla_attention` reads them:
    tensors, or ``{"q" | "q4", "s"}`` with scales ``[B, H, S]`` (a view of
    the ``shbd`` ``[S, H, B]`` ones)."""
    pax = POS_AXIS[layout]
    key = "q4" if _int4_cache(cache) else "q"
    out = []
    for name in ("k", "v"):
        t = cache[name][li]
        if window is not None:
            t = t.narrow(pax, 0, min(window, t.shape[pax]))
        if "k_s" not in cache:
            out.append(t)
            continue
        s = cache[name + "_s"][li]
        if layout == "shbd":
            s = s.permute(2, 1, 0)
        if window is not None:
            s = s[..., :t.shape[pax]]
        out.append({key: t, "s": s})
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _row_parallel(y: torch.Tensor, tp: bool) -> torch.Tensor:
    """A row-parallel projection's output: this rank's partial product,
    summed over the model group under tensor parallel."""
    return mesh_lib.all_reduce_model(y) if tp else y


def _train_layer(x: torch.Tensor, lp: Params, llora: Optional[Params],
                 cfg: LlamaConfig, cos, sin, attention_mask, scaling: float,
                 dropout_rate: float, dropout_seed: Optional[int],
                 attn_impl: str, tp: bool = False) -> torch.Tensor:
    """One layer of the no-cache path (``layer_body`` at
    ``ospo_tpu/models/llama.py:751-755``).  Under tensor parallel the
    normed input of the column-parallel projections (and their adapters)
    passes ``copy_to_model``, so its gradient sums the ranks' heads and
    FFN columns; the row-parallel outputs are summed by
    ``all_reduce_model``."""
    B, T = x.shape[:2]

    def proj(h, w, name):
        return _maybe_lora(h, w, llora, name, scaling, dropout_rate,
                           dropout_seed,
                           tp and name in ("o_proj", "down_proj"))

    def norm(x, w):
        h = rms_norm(x, w, cfg.rms_norm_eps)
        return mesh_lib.copy_to_model(h) if tp else h

    h = norm(x, lp["attn_norm"])
    q = proj(h, lp["wq"], "q_proj").view(B, T, cfg.num_heads, cfg.dim_head)
    k = proj(h, lp["wk"], "k_proj").view(B, T, cfg.kv_heads, cfg.dim_head)
    v = proj(h, lp["wv"], "v_proj").view(B, T, cfg.kv_heads, cfg.dim_head)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    attn = attention(q, k, v, mask=attention_mask, impl=attn_impl)
    x = x + _row_parallel(proj(attn.reshape(B, T, cfg.num_heads * cfg.dim_head),
                               lp["wo"], "o_proj"), tp)
    h = norm(x, lp["mlp_norm"])
    gate = proj(h, lp["w_gate"], "gate_proj")
    up = proj(h, lp["w_up"], "up_proj")
    act = F.silu(gate.float()).to(h.dtype) * up
    return x + _row_parallel(proj(act, lp["w_down"], "down_proj"), tp)


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
            attn_window: Optional[int] = None,
            cache_positions: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the decoder trunk; returns (final-norm hidden states, cache).

    Without a cache: ``attention_mask`` is ``[B, T]`` and attention is causal
    over the inputs.  ``self_attn=True`` (prefill into an empty cache):
    writes the T rows and attends over them, mask ``[B, T]``.  A cached
    step writes its T rows at ``cache['length']`` (one host integer for
    every row) and reads positions ``[0, length + T)`` of the cache,
    causally; ``attention_mask`` covers the whole cache window
    ``[B, S_max]`` (int32).  On a model-dtype or int8 ``shbd`` cache T = 1
    runs the decode-attention kernel (MHA), and T > 1 — step 4b's question
    suffixes — the suffix-attention kernel where
    ``ops/suffix_attention.suffix_attention_takes`` accepts the step (bf16
    queries on the card, MHA, head dim 128).  Every other cached read (the
    ``bshd`` and ``bhsd`` layouts, an int4 cache, per-row offsets, the CPU)
    takes the plain ``xla_attention`` over the
    layer's cache, the path of the JAX package without its decode kernel;
    ``attn_window`` truncates that read to the first ``attn_window``
    positions (and the mask with it), and an ``shbd`` T > 1 step reads only
    the ``length + T`` rows its causality reaches.  Over such an ``shbd``
    MHA cache (no int4 payload, no per-row offsets), bf16 activations on the
    card run the chain between the products as the kernels of
    ``ops/layer_tail.py`` (``layer_tail.takes``): each residual add with the
    norm after it, rope with the cache write, SiLU·up; everywhere else it
    runs as plain ops.

    ``cache['length']`` may instead be an int32 tensor ``[1]`` in device
    memory, for a T = 1 step on the decode kernel's cache (``shbd``, a
    model-dtype or int8 payload, MHA, no ``prefix_kv``): the step writes
    its row at that index, the kernel reads the length when it runs, and
    the step advances the tensor in place.  Such a step makes no host
    value and reads none, so it can be captured once in a CUDA graph and
    replayed at every length (``engine/image_engine.py``).

    ``cache_positions`` ``[B]`` (``bshd`` / ``bhsd`` caches) writes each
    row's T rows at its own offset and makes the causal offset per row —
    speculative Jacobi decoding's rows advance unevenly
    (``ospo_tpu/models/llama.py:439-526``).  The combinations the JAX
    package asserts against raise ``ValueError``: int4 KV with GQA or with
    per-row offsets, per-row offsets on ``shbd``, ``prefix_kv`` with
    per-row offsets.

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

    Tensor parallel (``parallel/mesh.py``): a trunk sharded by
    ``shard_janus_params`` runs this rank's heads and FFN columns (the head
    counts come from the shard, :func:`local_config`) and sums the
    row-parallel ``wo`` and ``w_down`` products over the model group; in
    training the collectives carry their gradients (``_train_layer``).
    """
    local = local_config(cfg, params)
    tp, cfg = local is not cfg, local
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
                    lora_dropout, seed, attn_impl, tp)
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
    layout = kv_cache.get("layout", "shbd")
    per_row = cache_positions is not None
    int4 = _int4_cache(kv_cache)
    if int4 and cfg.kv_heads != cfg.num_heads:
        raise ValueError("int4 KV currently supports MHA only (head-pair "
                         "packing)")
    if int4 and per_row:
        raise ValueError("int4 KV does not support per-row offsets (SJD)")
    if per_row and layout == "shbd":
        raise ValueError("per-row cache offsets (SJD) not supported "
                         "batch-minor")
    if per_row and prefix_kv is not None:
        raise ValueError(
            "prefix_kv (batch-shared KV segment) is supported on the standard "
            "cached path only — not SJD per-row offsets or the Pallas decode "
            "kernel")
    # the batch-minor model-dtype / int8 cache has the decode kernel, the
    # T == 1 prefix form and, for T > 1, the suffix kernel (MHA only);
    # everything else reads through xla_attention
    shbd_read = layout == "shbd" and not int4 and not per_row
    mha = cfg.kv_heads == cfg.num_heads
    kernel = shbd_read and T == 1 and mha and prefix_kv is None
    prefix_decode = shbd_read and T == 1 and mha and prefix_kv is not None
    device_len = isinstance(cache_len, torch.Tensor)
    if device_len and (self_attn or not kernel):
        raise ValueError("a device cache length takes the decode kernel's "
                         "T = 1 step (shbd model-dtype or int8 cache, MHA, "
                         "no prefix_kv)")
    if self_attn and cache_len != 0 and not per_row:
        raise ValueError("self_attn prefill needs an empty cache")
    # where the step writes and how far the kernel reads
    write_at = cache_len.long() if device_len else cache_len
    read_len = cache_len + T
    window = cache_len + T if shbd_read and T > 1 else attn_window
    mask_w = attention_mask if window is None else attention_mask[:, :window]

    # on the card the chain between the products runs as three kernels
    # (``ops/layer_tail.py``); on either route each residual add is taken
    # with the norm after it, so a layer's normed input comes from the
    # layer before and the last one's is the final norm
    tail = shbd_read and mha and layer_tail.takes(x, kv_cache, cfg.dim_head,
                                                  cfg.intermediate_size)
    add_norm = layer_tail.add_rms_norm if tail else layer_tail.add_rms_norm_plain
    silu_mul = layer_tail.silu_mul if tail else layer_tail.silu_mul_plain
    eps, norms = cfg.rms_norm_eps, params["layers"]["attn_norm"]
    h = add_norm(x, None, norms[0], eps)[1]
    pm = None if prefix_kv is None else prefix_kv["mask"]
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        pk = pv = None
        if prefix_kv is not None:
            pk, pv = prefix_kv["k"][li], prefix_kv["v"][li]
        q, k, v = linears(h, (lp["wq"], lp["wk"], lp["wv"]))
        q = q.view(B, T, cfg.num_heads, cfg.dim_head)
        k = k.view(B, T, cfg.kv_heads, cfg.dim_head)
        v = v.view(B, T, cfg.kv_heads, cfg.dim_head)
        if tail:
            q, k = layer_tail.rope_kv_write(q, k, v, cos, sin, kv_cache, li,
                                            write_at, roped_k=self_attn)
        else:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            _write_kv(kv_cache, li, write_at, k, v, cache_positions)
        if self_attn:
            attn = attention(q, k, v, mask=attention_mask, prefix_k=pk,
                             prefix_v=pv, prefix_mask=pm)
        elif kernel:
            attn = decode_attention(q, kv_cache["k"], kv_cache["v"], li,
                                    read_len, attention_mask,
                                    k_scale=kv_cache.get("k_s"),
                                    v_scale=kv_cache.get("v_s"))
        elif prefix_decode:
            attn = prefix_decode_attention(
                q, kv_cache["k"], kv_cache["v"], li, cache_len + 1,
                attention_mask, pk, pv, pm, k_scale=kv_cache.get("k_s"),
                v_scale=kv_cache.get("v_s"))
        elif suffix_attention_takes(q, kv_cache, per_row, pk):
            attn = suffix_attention(q, kv_cache["k"], kv_cache["v"], li,
                                    cache_len, attention_mask, pk, pv, pm,
                                    k_scale=kv_cache.get("k_s"),
                                    v_scale=kv_cache.get("v_s"))
        else:
            k_att, v_att = _cache_window(kv_cache, li, layout, window)
            attn = xla_attention(
                q, k_att, v_att, mask_w,
                cache_positions if per_row else cache_len, True, pk, pv, pm,
                kv_layout=layout)
        x, h = add_norm(x, _row_parallel(linear(
            attn.reshape(B, T, cfg.num_heads * cfg.dim_head), lp["wo"], tp), tp),
            lp["mlp_norm"], eps)
        gate, up = linears(h, (lp["w_gate"], lp["w_up"]))
        last = li == cfg.num_layers - 1
        x, h = add_norm(x, _row_parallel(linear(silu_mul(gate, up), lp["w_down"], tp), tp),
                        params["final_norm"] if last else norms[li + 1], eps)

    if device_len:
        cache_len.add_(T)
    else:
        kv_cache["length"] = read_len
    return h, kv_cache


def logits_from_hidden(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Hidden states [B, T, D] → text logits [B, T, V]: the product in the
    model dtype, cast to fp32 (``ospo_tpu/models/llama.py:779-780``); a
    vocab-parallel head's slices are joined over the model group."""
    head = params["lm_head"]
    logits = (hidden @ head.T).float()
    return mesh_lib.all_gather_last(logits) if mesh_lib.is_vocab_shard(
        head) else logits


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table; a vocab-parallel table looks up the ids
    in its own rows (zeros elsewhere) and sums over the model group."""
    table = params["embed"]
    if not mesh_lib.is_vocab_shard(table):
        return table[input_ids]
    local = input_ids - mesh_lib.vocab_offset(table)
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return mesh_lib.all_reduce_model(
        torch.where(mine[..., None], rows, torch.zeros_like(rows)))


def positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Rotary positions for left-padded batches: cumsum of validity − 1,
    clipped at 0 (``llama.py:787``)."""
    return (torch.cumsum(attention_mask.to(torch.int32), dim=-1) - 1).clamp_min(0)
