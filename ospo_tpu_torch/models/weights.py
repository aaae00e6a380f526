"""Parameter loading for the port.

- :func:`from_jax_params` maps a JAX-package parameter tree (numpy leaves)
  to the port's tree: convolution kernels (the VQ model's and the SigLIP
  patch embedding) HWIO → OIHW, everything else as stored (the stacked
  ``[L, out, in]`` trunk and ViT blocks included).  It is how both
  packages compute on the same weights in the tests, and how a full
  fine-tune checkpoint is read; :func:`to_jax_layout` is its inverse, how
  one is written.
- :func:`load_janus` reads an HF-keyed Janus-Pro safetensors checkpoint by
  the key map of ``ospo_tpu/models/weights.py`` (``port_llama`` :170,
  ``port_vit`` :203, ``_port_attn_pool`` :244, ``port_vqgan`` :307,
  ``port_mlp_projector`` :378, ``port_vision_head`` :392,
  ``config_from_checkpoint`` :410): the trunk, ``lm_head`` on request, the
  understanding tower (SigLIP and the aligner) and the generation side
  unless dropped.  Every key it reads is recorded, and a key-coverage audit
  (``check_key_coverage`` :96) fails the load on any key neither read nor
  skipped by name.  The shards are read by the port's own safetensors
  reader (``utils/safetensors_io.py``), a tensor at a time.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ospo_tpu_torch.models import deepseek_v2
from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import kimi_linear
from ospo_tpu_torch.models import qwen3_next
from ospo_tpu_torch.models import llama as llama_lib
from ospo_tpu_torch.models import vit as vit_lib
from ospo_tpu_torch.models import vqgan as vqgan_lib
from ospo_tpu_torch.utils.safetensors_io import SafeOpen

Params = Dict[str, Any]

_KEYS = ("language_model", "vision_model", "aligner", "gen_vision_model",
         "gen_aligner", "gen_head", "gen_embed")


def _to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    # ml_dtypes bf16, or the 2-byte void a bf16 array reads back as from an
    # ``.npz``: reinterpret the bits
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def map_tree(tree, fn, path=()):
    """``fn(path, leaf)`` over a nested dict / list tree, same structure."""
    if isinstance(tree, Mapping):
        return {k: map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def from_jax_params(tree: Params, device=None) -> Params:
    """JAX Janus param tree (numpy leaves) → port params on ``device``:
    the language model (``lm_head`` included), the understanding tower and
    the generation side, each where the tree has it."""
    device = torch.device(device or "cpu")

    def leaf(path, x):
        t = _to_torch(x, device)
        if path[0] in ("gen_vision_model", "vision_model") and path[-1] == "w" \
                and t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()      # HWIO → OIHW
        return t

    return map_tree({k: tree[k] for k in _KEYS if k in tree}, leaf)


def to_jax_layout(tree: Params) -> Params:
    """Port param tree → the JAX package's layout (torch leaves, detached),
    the inverse of :func:`from_jax_params`: convolution kernels OIHW →
    HWIO, everything else as it is."""

    def leaf(path, t):
        t = t.detach()
        if path[0] in ("gen_vision_model", "vision_model") and path[-1] == "w" \
                and t.ndim == 4:
            t = t.permute(2, 3, 1, 0)                    # OIHW → HWIO
        return t

    return map_tree(tree, leaf)


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------


def config_from_checkpoint(model_path: str) -> janus_lib.JanusConfig:
    """JanusConfig from the HF ``config.json``."""
    with open(os.path.join(model_path, "config.json")) as f:
        hf = json.load(f)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        hf.get("torch_dtype"), torch.bfloat16)
    lc = hf.get("language_config", {})
    if lc.get("model_type") == "deepseek_v2":
        lang = deepseek_v2.config_from_hf(lc, dtype)
    elif lc.get("model_type") == "qwen3_next":
        lang = qwen3_next.config_from_hf(lc, dtype)
    elif lc.get("model_type") == "kimi_linear":
        lang = kimi_linear.config_from_hf(lc, dtype)
    else:
        lang = llama_lib.LlamaConfig(
            vocab_size=lc.get("vocab_size", 102400),
            hidden_size=lc.get("hidden_size", 4096),
            intermediate_size=lc.get("intermediate_size", 11008),
            num_layers=lc.get("num_hidden_layers", 30),
            num_heads=lc.get("num_attention_heads", 32),
            num_kv_heads=lc.get("num_key_value_heads"),
            rope_theta=lc.get("rope_theta", 10000.0),
            rms_norm_eps=lc.get("rms_norm_eps", 1e-6),
            max_seq_len=lc.get("max_position_embeddings", 4096),
            dtype=dtype,
        )
    gvp = hf.get("gen_vision_config", {}).get("params", {})
    vqp = gvp.get("vq")
    vq = vqgan_lib.VQConfig(
        codebook_size=vqp.get("codebook_size", 16384),
        codebook_dim=vqp.get("codebook_dim", 8),
        base_ch=vqp.get("base_ch", 128),
        ch_mult=tuple(vqp.get("ch_mult", (1, 1, 2, 2, 4))),
        num_res_blocks=vqp.get("num_res_blocks", 2),
        z_channels=vqp.get("z_channels", 256),
    ) if vqp else vqgan_lib.VQ_16
    gap = hf.get("gen_aligner_config", {}).get("params", {})
    ap = hf.get("aligner_config", {}).get("params", {})
    vp = hf.get("vision_config", {}).get("params", {})
    base_vit = {"siglip_large_patch16_384": vit_lib.SIGLIP_LARGE_384,
                "siglip_so400m_patch14_384": vit_lib.SIGLIP_SO400M_384}.get(
        vp.get("model_name", "siglip_large_patch16_384"),
        vit_lib.SIGLIP_LARGE_384)
    # explicit shape fields (synthetic checkpoints describe themselves
    # beyond the reference's model_name registry) win over the preset
    vision = dataclasses.replace(
        base_vit, image_size=vp.get("image_size", 384),
        select_layer=vp.get("select_layer", base_vit.select_layer),
        dtype=dtype,
        **{k: vp[k] for k in ("width", "layers", "heads", "patch_size",
                              "mlp_ratio") if k in vp})
    return janus_lib.JanusConfig(
        language=lang,
        vision=vision,
        vq=vq,
        gen_embed_dim=gvp.get("n_embed", 8),
        image_token_size=gvp.get("image_token_size", 16384),
        gen_image_size=gvp.get("image_size", 384),
        aligner_depth=ap.get("depth", 2),
        gen_aligner_depth=gap.get("depth", 2),
        dtype=dtype,
    )


class _Checkpoint:
    """Lazy key → tensor reader over the ``*.safetensors`` shards; records
    the keys read (an ``in`` test reads nothing) for the coverage audit."""

    def __init__(self, model_path: str, device):
        shards = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
        if not shards:
            raise FileNotFoundError(f"no *.safetensors under {model_path}")
        self._files = [SafeOpen(s) for s in shards]
        self._where = {k: f for f in self._files for k in f.keys()}
        self.device = device
        self.consumed: set = set()

    def keys(self):
        return self._where.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._where

    def get(self, key: str, dtype=None) -> torch.Tensor:
        self.consumed.add(key)
        t = self._where[key].get_tensor(key)
        return t.to(device=self.device, dtype=dtype or t.dtype)


# key prefixes of the parts a load may leave out, by load_janus's flag
_PART_PREFIXES = {
    "lm_head": ("language_model.lm_head.",),
    "understanding": ("vision_model.", "aligner."),
    "vision": ("gen_vision_model.", "gen_aligner.", "gen_head.", "gen_embed."),
}


def expected_skipped_keys(keys, cfg: janus_lib.JanusConfig,
                          dropped=()) -> set:
    """Checkpoint keys a load leaves unread on purpose
    (``ospo_tpu/models/weights.py:75-93``): ViT blocks past the
    ``select_layer`` depth, the per-layer ``rotary_emb.inv_freq`` buffers
    (recomputed from ``rope_theta``), and every key of a part the caller
    dropped (``dropped``: names of :data:`_PART_PREFIXES`)."""
    skipped = set()
    for i in range(cfg.vision.depth, cfg.vision.layers):
        pre = f"vision_model.vision_tower.blocks.{i}."
        skipped |= {k for k in keys if k.startswith(pre)}
    skipped |= {k for k in keys if k.endswith("rotary_emb.inv_freq")}
    if janus_lib.is_hybrid(cfg.language):   # the experts other chips of a share hold
        lo, n = cfg.language.held_range
        skipped |= {k for k in keys if ".experts." in k
                    and not lo <= int(k.split(".experts.")[1].split(".")[0]) < lo + n}
    prefixes = tuple(p for part in dropped for p in _PART_PREFIXES[part])
    if prefixes:
        skipped |= {k for k in keys if k.startswith(prefixes)}
    return skipped


def check_key_coverage(keys, cfg: janus_lib.JanusConfig, consumed,
                       dropped=(), context: str = "checkpoint") -> Dict[str, int]:
    """Every checkpoint key read or skipped by name, or ``ValueError``
    naming the leftovers (``ospo_tpu/models/weights.py:96-116``)."""
    keys = set(keys)
    skipped = expected_skipped_keys(keys, cfg, dropped)
    leftover = sorted(keys - set(consumed) - skipped)
    if leftover:
        head = "\n  ".join(leftover[:20])
        more = f"\n  ... and {len(leftover) - 20} more" if len(leftover) > 20 else ""
        raise ValueError(
            f"key-coverage audit failed for {context}: {len(leftover)} "
            f"key(s) neither read by the port nor skipped by name:\n  {head}"
            f"{more}\n(read={len(set(consumed) & keys)}, skipped="
            f"{len(skipped)}, total={len(keys)})")
    return {"consumed": len(set(consumed) & keys), "skipped": len(skipped)}


def _port_llama(ck: _Checkpoint, cfg: llama_lib.LlamaConfig, quantize,
                lm_head: bool, prefix: str = "language_model.") -> Params:
    """The trunk; ``quantize`` (a mode of ``quant.quant_mode``) quantizes
    each layer's projection as it is read."""
    from ospo_tpu_torch.ops import quant

    mode = quant.quant_mode(quantize)
    dt = cfg.dtype
    names = {
        "attn_norm": "input_layernorm", "wq": "self_attn.q_proj",
        "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
        "wo": "self_attn.o_proj", "mlp_norm": "post_attention_layernorm",
        "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
        "w_down": "mlp.down_proj",
    }
    layers: Params = {}
    for name, hf in names.items():
        mats = [ck.get(f"{prefix}model.layers.{i}.{hf}.weight", dt)
                for i in range(cfg.num_layers)]
        if mode and name in quant.QUANTIZABLE:
            qfn = quant.quant_fn(mode)
            qs = [qfn(m) for m in mats]  # torch [out, in]
            layers[name] = {k: torch.stack([x[k] for x in qs]) for k in qs[0]}
        else:
            layers[name] = torch.stack(mats)
        del mats
    out = {
        "embed": ck.get(prefix + "model.embed_tokens.weight", dt),
        "layers": layers,
        "final_norm": ck.get(prefix + "model.norm.weight", dt),
    }
    if lm_head:
        out["lm_head"] = ck.get(prefix + "lm_head.weight", dt)
    return out


def _port_deepseek_v2(ck: _Checkpoint, cfg: deepseek_v2.DeepseekV2Config,
                      quantize, lm_head: bool,
                      prefix: str = "language_model.") -> Params:
    """The MLA/MoE trunk (``models/deepseek_v2.py``'s tree).  ``quantize``
    ("" or "int8") quantizes every projection, the shared experts and the
    routed experts, each matrix as it is read, into int8 stacks allocated
    once: no stack of model-dtype experts is ever made.  The router stays
    in the model dtype."""
    from ospo_tpu_torch.ops import quant

    mode = quant.quant_mode(quantize)
    if mode not in ("", "int8"):
        raise NotImplementedError(
            f"quantize {mode!r}: the MLA/MoE trunk takes int8 (W8A16) or the "
            "model dtype")
    dt = cfg.dtype
    qfn = quant.quant_fn(mode) if mode else None
    pre = prefix + "model.layers."

    def stack(keys, quantized: bool):
        return _stack(ck, keys, dt, qfn if quantized else None)

    L = cfg.num_layers
    attn = {"attn_norm": ("input_layernorm", False),
            "wq": ("self_attn.q_proj", True),
            "wkv_a": ("self_attn.kv_a_proj_with_mqa", True),
            "kv_norm": ("self_attn.kv_a_layernorm", False),
            "wkv_b": ("self_attn.kv_b_proj", True),
            "wo": ("self_attn.o_proj", True),
            "mlp_norm": ("post_attention_layernorm", False)}
    layers = {name: stack([f"{pre}{i}.{hf}.weight" for i in range(L)], q)
              for name, (hf, q) in attn.items()}

    def mlp(layer_ids, part):
        return {name: stack([f"{pre}{i}.{part}.{hf}.weight" for i in layer_ids], True)
                for name, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                                 ("w_down", "down_proj"))}

    moe_ids = range(cfg.n_dense, L)
    out = {
        "embed": ck.get(prefix + "model.embed_tokens.weight", dt),
        "layers": layers,
        "moe": {"router": stack([f"{pre}{i}.mlp.gate.weight" for i in moe_ids], False)},
        "final_norm": ck.get(prefix + "model.norm.weight", dt),
    }
    if cfg.n_dense:
        out["dense"] = mlp(range(cfg.n_dense), "mlp")
    out["moe"]["w13"], out["moe"]["w2"] = _port_experts(
        ck, qfn, dt, [f"{pre}{i}.mlp." for i in moe_ids], range(cfg.n_routed_experts),
        "shared_experts", cfg.n_shared_experts)
    out["layers"]["w_uk"], out["layers"]["w_uv"] = deepseek_v2.absorbed(
        layers["wkv_b"], cfg)
    if lm_head:
        out["lm_head"] = ck.get(prefix + "lm_head.weight", dt)
    return out


def _stack(ck: _Checkpoint, keys, dt, qfn=None):
    """The matrices of ``keys`` stacked on a leading axis, each read,
    quantized by ``qfn`` (if given) and written on its own."""
    out = None
    for idx, key in enumerate(keys):
        w = ck.get(key, dt)
        parts = qfn(w) if qfn else {"w": w}
        if out is None:
            out = {n: torch.empty((len(keys), *t.shape), dtype=t.dtype,
                                  device=t.device) for n, t in parts.items()}
        for n, t in parts.items():
            out[n][idx] = t
    return out["w"] if "w" in out else out


def _port_experts(ck: _Checkpoint, qfn, dt, mlps, expert_ids, shared: str, S: int,
                  names=("gate_proj", "up_proj", "down_proj")):
    """``w13`` ``[Lm, E + S, 2F, D]`` (gate rows, then up rows) and ``w2``
    ``[Lm, E + S, D, F]`` of the MoE layers whose ``mlp.`` prefixes are
    ``mlps``: the E routed experts ``expert_ids``, then the shared MLP
    ``mlp.<shared>`` (width ``S · F``) cut into S experts of width F (its
    down rows quantized whole, so each part keeps the row's scale).  Each
    matrix is read, quantized and written into stacks allocated once.
    ``names``: a routed expert's gate, up and down matrices (the shared
    MLP's are always ``gate_proj``, ``up_proj``, ``down_proj``)."""
    E = len(expert_ids)
    stacks = [None, None]

    def put(which, m, e, w):
        parts = qfn(w) if qfn else {"w": w}
        if stacks[which] is None:
            stacks[which] = {n: torch.empty((len(mlps), E + S, *t.shape),
                                            dtype=t.dtype, device=t.device)
                             for n, t in parts.items()}
        for n, t in parts.items():
            stacks[which][n][m, e] = t

    def mats(key, parts=("gate_proj", "up_proj", "down_proj")):
        return [ck.get(f"{key}.{n}.weight", dt) for n in parts]

    for m, mlp in enumerate(mlps):
        for e, ex in enumerate(expert_ids):
            g, u, d = mats(f"{mlp}experts.{ex}", names)
            put(0, m, e, torch.cat([g, u]))
            put(1, m, e, d)
        if not S:
            continue
        g, u, d = mats(mlp + shared)
        if qfn:   # the whole down rows' scales, then cut by columns
            qd = qfn(d)
            stacks[1]["q"][m, E:] = torch.stack(qd["q"].chunk(S, dim=1))
            stacks[1]["s"][m, E:] = qd["s"]
        else:
            stacks[1]["w"][m, E:] = torch.stack(d.chunk(S, dim=1))
        for j, (gj, uj) in enumerate(zip(g.chunk(S), u.chunk(S))):
            put(0, m, E + j, torch.cat([gj, uj]))
    return tuple(st["w"] if "w" in st else st for st in stacks)


def _port_qwen3_next(ck: _Checkpoint, cfg: qwen3_next.Qwen3NextConfig, quantize,
                     lm_head: bool, prefix: str = "language_model.") -> Params:
    """The GDN/MoE trunk (``models/qwen3_next.py``'s tree).  ``quantize``
    ("" or "int8") quantizes every projection, the shared expert and the
    held routed experts, each matrix as it is read; the routers, the
    shared-expert gates and the conv stay in the model dtype; A_log,
    dt_bias, the gated norms' scales and every zero-centred norm's ``1 +
    w`` are kept in fp32."""
    from ospo_tpu_torch.ops import quant

    mode = quant.quant_mode(quantize)
    if mode not in ("", "int8"):
        raise NotImplementedError(
            f"quantize {mode!r}: the GDN/MoE trunk takes int8 (W8A16) or the "
            "model dtype")
    dt = cfg.dtype
    qfn = quant.quant_fn(mode) if mode else None
    pre = prefix + "model.layers."
    L = cfg.num_layers
    full = [i for i in range(L) if cfg.is_full(i)]
    gdn = [i for i in range(L) if not cfg.is_full(i)]

    def stack(ids, name, quantized=True):
        return _stack(ck, [f"{pre}{i}.{name}.weight" for i in ids], dt,
                      qfn if quantized else None)

    def offset(ids, name):   # a zero-centred norm's scale 1 + w, fp32
        return 1.0 + stack(ids, name, False).float()

    def fp32(ids, name):
        return torch.stack([ck.get(f"{pre}{i}.{name}", torch.float32) for i in ids])

    lin = "linear_attn."
    conv = stack(gdn, lin + "conv1d", False)
    routers = [torch.cat([ck.get(f"{pre}{i}.mlp.gate.weight", dt),
                          ck.get(f"{pre}{i}.mlp.shared_expert_gate.weight", dt)])
               for i in range(L)]
    lo, n = cfg.held_range
    out = {
        "embed": ck.get(prefix + "model.embed_tokens.weight", dt),
        "layers": {"attn_norm": offset(range(L), "input_layernorm"),
                   "mlp_norm": offset(range(L), "post_attention_layernorm")},
        "gdn": {"in_qkvz": stack(gdn, lin + "in_proj_qkvz"),
                "in_ba": stack(gdn, lin + "in_proj_ba"),
                "conv_w": conv.reshape(len(gdn), conv.shape[1], -1).contiguous(),
                "A_log": fp32(gdn, lin + "A_log"), "dt_bias": fp32(gdn, lin + "dt_bias"),
                "norm": stack(gdn, lin + "norm", False).float(),
                "out": stack(gdn, lin + "out_proj")},
        "full": {"wq": stack(full, "self_attn.q_proj"),
                 "wk": stack(full, "self_attn.k_proj"),
                 "wv": stack(full, "self_attn.v_proj"),
                 "wo": stack(full, "self_attn.o_proj"),
                 "q_norm": offset(full, "self_attn.q_norm"),
                 "k_norm": offset(full, "self_attn.k_norm")},
        "moe": {"router": torch.stack(routers)},
        "final_norm": 1.0 + ck.get(prefix + "model.norm.weight", dt).float(),
    }
    del routers
    out["moe"]["w13"], out["moe"]["w2"] = _port_experts(
        ck, qfn, dt, [f"{pre}{i}.mlp." for i in range(L)], range(lo, lo + n),
        "shared_expert", cfg.n_shared)
    if lm_head:
        out["lm_head"] = ck.get(prefix + "lm_head.weight", dt)
    return out


def _port_kimi_linear(ck: _Checkpoint, cfg: kimi_linear.KimiLinearConfig, quantize,
                      lm_head: bool, prefix: str = "language_model.") -> Params:
    """The KDA/MLA/MoE trunk (``models/kimi_linear.py``'s tree).  ``quantize``
    ("" or "int8") quantizes every projection (the KDA layers' low-rank
    ones too), the dense MLP, the shared expert and the held routed
    experts, each matrix as it is read; the routers and the conv stay in
    the model dtype; the correction biases, A_log, dt_bias and ``o_norm``'s
    scale are kept in fp32.  Keys: ``self_attn.*`` for both mixers (KDA's
    ``q_proj``, ``k_proj``, ``v_proj``, ``q_conv1d``, ``k_conv1d``,
    ``v_conv1d``, ``f_a_proj``, ``f_b_proj``, ``g_a_proj``, ``g_b_proj``,
    ``b_proj``, ``A_log``, ``dt_bias``, ``o_norm``, ``o_proj``; MLA's
    DeepSeek-V2 names), ``mlp.*`` for the dense layer, and
    ``block_sparse_moe.gate`` (``weight``, ``e_score_correction_bias``),
    ``block_sparse_moe.experts.{e}.w1/w3/w2`` (gate, up, down) and
    ``block_sparse_moe.shared_experts.*`` for the MoE layers."""
    from ospo_tpu_torch.ops import quant

    mode = quant.quant_mode(quantize)
    if mode not in ("", "int8"):
        raise NotImplementedError(
            f"quantize {mode!r}: the {kimi_linear.TRUNK} takes int8 (W8A16) or the "
            "model dtype")
    dt = cfg.dtype
    qfn = quant.quant_fn(mode) if mode else None
    pre = prefix + "model.layers."
    L = cfg.num_layers
    kda = list(cfg.kda_layers)
    mla = [i for i in range(L) if not cfg.is_kda(i)]
    moe_ids = range(cfg.n_dense, L)

    def stack(ids, name, quantized=True):
        return _stack(ck, [f"{pre}{i}.{name}.weight" for i in ids], dt,
                      qfn if quantized else None)

    def fp32(ids, name):
        return torch.stack([ck.get(f"{pre}{i}.{name}", torch.float32).reshape(-1)
                            for i in ids])

    a = "self_attn."
    conv = torch.cat([stack(kda, a + f"{n}_conv1d", False) for n in "qkv"], dim=1)
    mla_tree = {name: stack(mla, a + hf, q) for name, (hf, q) in {
        "wq": ("q_proj", True), "wkv_a": ("kv_a_proj_with_mqa", True),
        "kv_norm": ("kv_a_layernorm", False), "wkv_b": ("kv_b_proj", True),
        "wo": ("o_proj", True)}.items()}
    mla_tree["w_uk"], mla_tree["w_uv"] = deepseek_v2.absorbed(mla_tree["wkv_b"], cfg.mla)
    moe_pre = [f"{pre}{i}.block_sparse_moe." for i in moe_ids]
    lo, n = cfg.held_range
    out = {
        "embed": ck.get(prefix + "model.embed_tokens.weight", dt),
        "layers": {"attn_norm": stack(range(L), "input_layernorm", False),
                   "mlp_norm": stack(range(L), "post_attention_layernorm", False)},
        "kda": {name: stack(kda, a + hf) for name, hf in (
            ("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("f_a", "f_a_proj"),
            ("f_b", "f_b_proj"), ("g_a", "g_a_proj"), ("g_b", "g_b_proj"),
            ("wb", "b_proj"), ("wo", "o_proj"))},
        "mla": mla_tree,
        "moe": {"router": _stack(ck, [p + "gate.weight" for p in moe_pre], dt),
                "bias": torch.stack([ck.get(p + "gate.e_score_correction_bias",
                                            torch.float32) for p in moe_pre])},
        "final_norm": ck.get(prefix + "model.norm.weight", dt),
    }
    out["kda"].update(conv_w=conv.reshape(len(kda), conv.shape[1], -1).contiguous(),
                      A_log=fp32(kda, a + "A_log"), dt_bias=fp32(kda, a + "dt_bias"),
                      norm=stack(kda, a + "o_norm", False).float())
    if cfg.n_dense:
        out["dense"] = {name: stack(range(cfg.n_dense), f"mlp.{hf}") for name, hf in (
            ("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj"))}
    out["moe"]["w13"], out["moe"]["w2"] = _port_experts(
        ck, qfn, dt, moe_pre, range(lo, lo + n), "shared_experts", cfg.n_shared,
        names=("w1", "w3", "w2"))
    if lm_head:
        out["lm_head"] = ck.get(prefix + "lm_head.weight", dt)
    return out


def _port_vq(ck: _Checkpoint, cfg: vqgan_lib.VQConfig,
             prefix: str = "gen_vision_model.") -> Params:
    f32 = torch.float32

    def conv(name):  # checkpoint kernels are OIHW already
        return {"w": ck.get(name + ".weight", f32), "b": ck.get(name + ".bias", f32)}

    def gn(name):
        return {"scale": ck.get(name + ".weight", f32),
                "bias": ck.get(name + ".bias", f32)}

    def res(name):
        p = {"norm1": gn(name + ".norm1"), "conv1": conv(name + ".conv1"),
             "norm2": gn(name + ".norm2"), "conv2": conv(name + ".conv2")}
        if name + ".nin_shortcut.weight" in ck:
            p["nin_shortcut"] = conv(name + ".nin_shortcut")
        return p

    def attn(name):
        return {"norm": gn(name + ".norm"), "q": conv(name + ".q"),
                "k": conv(name + ".k"), "v": conv(name + ".v"),
                "proj_out": conv(name + ".proj_out")}

    def levels(side: str, n_res: int, resample: str):
        out = []
        for i in range(len(cfg.ch_mult)):
            base = f"{prefix}{side}.conv_blocks.{i}"
            level: Params = {"res": [], "attn": []}
            for j in range(n_res):
                level["res"].append(res(f"{base}.res.{j}"))
                if f"{base}.attn.{j}.q.weight" in ck:
                    level["attn"].append(attn(f"{base}.attn.{j}"))
            if f"{base}.{resample}.conv.weight" in ck:
                level[resample] = conv(f"{base}.{resample}.conv")
            out.append(level)
        return out

    def tower(side: str, n_res: int, resample: str) -> Params:
        d = f"{prefix}{side}."
        return {"conv_in": conv(d + "conv_in"),
                "mid": [res(d + "mid.0"), attn(d + "mid.1"), res(d + "mid.2")],
                "levels": levels(side, n_res, resample),
                "norm_out": gn(d + "norm_out"),
                "conv_out": conv(d + "conv_out")}

    return {"encoder": tower("encoder", cfg.num_res_blocks, "downsample"),
            "decoder": tower("decoder", cfg.num_res_blocks + 1, "upsample"),
            "codebook": ck.get(prefix + "quantize.embedding.weight", f32),
            "quant_conv": conv(prefix + "quant_conv"),
            "post_quant_conv": conv(prefix + "post_quant_conv")}


def _port_vit(ck: _Checkpoint, cfg: vit_lib.ViTConfig,
              prefix: str = "vision_model.vision_tower.") -> Params:
    """timm naming; the first ``cfg.depth`` blocks stacked on a layer axis,
    the patch kernel OIHW as stored, the attention-pool head when the
    checkpoint carries it."""
    dt = cfg.dtype

    def stack(fmt: str) -> torch.Tensor:
        return torch.stack([ck.get(prefix + fmt.format(i), dt)
                            for i in range(cfg.depth)])

    names = {"norm1_scale": "norm1.weight", "norm1_bias": "norm1.bias",
             "wqkv": "attn.qkv.weight", "bqkv": "attn.qkv.bias",
             "wo": "attn.proj.weight", "bo": "attn.proj.bias",
             "norm2_scale": "norm2.weight", "norm2_bias": "norm2.bias",
             "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias",
             "w2": "mlp.fc2.weight", "b2": "mlp.fc2.bias"}
    out = {
        "patch_embed": {"w": ck.get(prefix + "patch_embed.proj.weight", dt),
                        "b": ck.get(prefix + "patch_embed.proj.bias", dt)},
        "pos_embed": ck.get(prefix + "pos_embed", dt),
        "blocks": {k: stack("blocks.{}." + v) for k, v in names.items()},
        "final_norm": {"scale": ck.get(prefix + "norm.weight", dt),
                       "bias": ck.get(prefix + "norm.bias", dt)},
    }
    if prefix + "attn_pool.latent" in ck:
        out["attn_pool"] = _port_attn_pool(ck, prefix + "attn_pool.", dt)
    return out


def _port_attn_pool(ck: _Checkpoint, prefix: str, dt) -> Params:
    def lin(name):
        return {"w": ck.get(f"{prefix}{name}.weight", dt),
                "b": ck.get(f"{prefix}{name}.bias", dt)}

    return {"latent": ck.get(prefix + "latent", dt), "q": lin("q"),
            "kv": lin("kv"), "proj": lin("proj"),
            "norm": {"scale": ck.get(prefix + "norm.weight", dt),
                     "bias": ck.get(prefix + "norm.bias", dt)},
            "fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2")}


def _port_mlp_projector(ck: _Checkpoint, prefix: str, depth: int, dtype) -> Params:
    """``mlp_gelu`` nn.Sequential: Linear at index 0, then 2, 4, ..."""
    return {"layers": [
        {"w": ck.get(f"{prefix}layers.{0 if i == 0 else 2 * i}.weight", dtype),
         "b": ck.get(f"{prefix}layers.{0 if i == 0 else 2 * i}.bias", dtype)}
        for i in range(depth)]}


def _port_vision_head(ck: _Checkpoint, prefix: str, dtype) -> Params:
    return {
        "proj": {"w": ck.get(prefix + "output_mlp_projector.weight", dtype),
                 "b": ck.get(prefix + "output_mlp_projector.bias", dtype)},
        "head": {"w": ck.get(prefix + "vision_head.weight", dtype),
                 "b": ck.get(prefix + "vision_head.bias", dtype)},
    }


def load_janus(model_path: str, device=None,
               cfg: Optional[janus_lib.JanusConfig] = None,
               quantize=False,
               lm_head: bool = False,
               vision: bool = True,
               understanding: bool = True) -> janus_lib.JanusModel:
    """Load an HF-keyed Janus-Pro checkpoint onto ``device`` (default
    ``cuda``): the trunk, ``lm_head`` on request, the understanding tower
    (SigLIP and the aligner) unless ``understanding`` is False, and with
    ``vision`` False neither the generation side nor the understanding
    tower; ``quantize`` (True = "int8", "int4", "int4g") quantizes the
    trunk layer by layer.  The key-coverage audit runs on every load."""
    device = torch.device(device or "cuda")
    cfg = cfg or config_from_checkpoint(model_path)
    understanding = understanding and vision
    ck = _Checkpoint(model_path, device)
    port = (_port_deepseek_v2 if deepseek_v2.is_mla(cfg.language) else
            _port_qwen3_next if qwen3_next.is_hybrid(cfg.language) else
            _port_kimi_linear if kimi_linear.is_kimi(cfg.language) else _port_llama)
    params = {"language_model": port(ck, cfg.language, quantize, lm_head)}
    if understanding:
        params["vision_model"] = _port_vit(ck, cfg.vision)
        params["aligner"] = _port_mlp_projector(ck, "aligner.",
                                                cfg.aligner_depth, cfg.dtype)
    if vision:
        params.update({
            "gen_vision_model": _port_vq(ck, cfg.vq),
            "gen_aligner": _port_mlp_projector(ck, "gen_aligner.",
                                               cfg.gen_aligner_depth, cfg.dtype),
            "gen_head": _port_vision_head(ck, "gen_head.", cfg.dtype),
            "gen_embed": ck.get("gen_embed.weight", cfg.dtype),
        })
    dropped = [part for part, kept in (("lm_head", lm_head),
                                       ("understanding", understanding),
                                       ("vision", vision)) if not kept]
    cov = check_key_coverage(ck.keys(), cfg, ck.consumed, dropped,
                             context=model_path)
    print(f"# key coverage: {cov['consumed']} read, {cov['skipped']} skipped "
          f"by name, 0 left over")
    return janus_lib.JanusModel(cfg, params, device)
