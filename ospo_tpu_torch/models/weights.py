"""Parameter loading for the port.

- :func:`from_jax_params` maps a JAX-package parameter tree (numpy leaves)
  to the port's tree: VQ convolution kernels HWIO → OIHW, everything else
  as stored (the stacked ``[L, out, in]`` trunk included).  It is how both
  packages compute on the same weights in the tests.
- :func:`load_janus` reads the generation-side keys of an HF-keyed Janus-Pro
  safetensors checkpoint, by the key map of ``ospo_tpu/models/weights.py``
  (``port_llama`` :170, ``port_vqgan`` :307, ``port_mlp_projector`` :378,
  ``port_vision_head`` :392, ``config_from_checkpoint`` :410).  The
  understanding tower and the encoder side of the VQ model are not read
  (not built in the port yet), nor is ``lm_head`` when it is dropped.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import llama as llama_lib
from ospo_tpu_torch.models import vqgan as vqgan_lib

Params = Dict[str, Any]

_GEN_KEYS = ("language_model", "gen_vision_model", "gen_aligner", "gen_head",
             "gen_embed")


def _to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map_tree(tree, fn, path=()):
    if isinstance(tree, Mapping):
        return {k: _map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def from_jax_params(tree: Params, device=None) -> Params:
    """JAX Janus param tree (numpy leaves) → port params on ``device``.
    Only the generation-side subtrees are taken."""
    device = torch.device(device or "cpu")

    def leaf(path, x):
        t = _to_torch(x, device)
        if path[0] == "gen_vision_model" and path[-1] == "w" and t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()      # HWIO → OIHW
        return t

    out = _map_tree({k: tree[k] for k in _GEN_KEYS if k in tree}, leaf)
    vq = out.get("gen_vision_model")
    if vq is not None:
        out["gen_vision_model"] = {k: vq[k] for k in
                                   ("decoder", "codebook", "post_quant_conv")}
    return out


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------


def config_from_checkpoint(model_path: str) -> janus_lib.JanusConfig:
    """JanusConfig (generation side) from the HF ``config.json``."""
    with open(os.path.join(model_path, "config.json")) as f:
        hf = json.load(f)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        hf.get("torch_dtype"), torch.bfloat16)
    lc = hf.get("language_config", {})
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
    return janus_lib.JanusConfig(
        language=lang,
        vq=vq,
        gen_embed_dim=gvp.get("n_embed", 8),
        image_token_size=gvp.get("image_token_size", 16384),
        gen_image_size=gvp.get("image_size", 384),
        gen_aligner_depth=gap.get("depth", 2),
        dtype=dtype,
    )


class _Checkpoint:
    """Lazy key → tensor reader over the ``*.safetensors`` shards."""

    def __init__(self, model_path: str, device):
        from safetensors import safe_open

        shards = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
        if not shards:
            raise FileNotFoundError(f"no *.safetensors under {model_path}")
        self._files = [safe_open(s, framework="pt") for s in shards]
        self._where = {k: f for f in self._files for k in f.keys()}
        self.device = device

    def __contains__(self, key: str) -> bool:
        return key in self._where

    def get(self, key: str, dtype=None) -> torch.Tensor:
        t = self._where[key].get_tensor(key)
        return t.to(device=self.device, dtype=dtype or t.dtype)


def _port_llama(ck: _Checkpoint, cfg: llama_lib.LlamaConfig, quantize: bool,
                lm_head: bool, prefix: str = "language_model.") -> Params:
    from ospo_tpu_torch.ops import quant

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
        if quantize and name in quant.QUANTIZABLE:
            qs = [quant.quantize_matrix(m) for m in mats]  # torch [out, in]
            layers[name] = {"q": torch.stack([x["q"] for x in qs]),
                            "s": torch.stack([x["s"] for x in qs])}
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


def _port_vq_decoder(ck: _Checkpoint, cfg: vqgan_lib.VQConfig,
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

    d = prefix + "decoder."
    dec: Params = {"conv_in": conv(d + "conv_in"),
                   "mid": [res(d + "mid.0"), attn(d + "mid.1"), res(d + "mid.2")]}
    levels = []
    for i in range(len(cfg.ch_mult)):
        base = f"{d}conv_blocks.{i}"
        level: Params = {"res": [], "attn": []}
        for j in range(cfg.num_res_blocks + 1):
            level["res"].append(res(f"{base}.res.{j}"))
            if f"{base}.attn.{j}.q.weight" in ck:
                level["attn"].append(attn(f"{base}.attn.{j}"))
        if f"{base}.upsample.conv.weight" in ck:
            level["upsample"] = conv(f"{base}.upsample.conv")
        levels.append(level)
    dec["levels"] = levels
    dec["norm_out"] = gn(d + "norm_out")
    dec["conv_out"] = conv(d + "conv_out")
    return {"decoder": dec,
            "codebook": ck.get(prefix + "quantize.embedding.weight", f32),
            "post_quant_conv": conv(prefix + "post_quant_conv")}


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
               quantize: bool = False,
               lm_head: bool = False) -> janus_lib.JanusModel:
    """Load the generation side of an HF-keyed Janus-Pro checkpoint onto
    ``device`` (default ``cuda``); ``quantize`` makes the trunk int8."""
    device = torch.device(device or "cuda")
    cfg = cfg or config_from_checkpoint(model_path)
    ck = _Checkpoint(model_path, device)
    params = {
        "language_model": _port_llama(ck, cfg.language, quantize, lm_head),
        "gen_vision_model": _port_vq_decoder(ck, cfg.vq),
        "gen_aligner": _port_mlp_projector(ck, "gen_aligner.",
                                           cfg.gen_aligner_depth, cfg.dtype),
        "gen_head": _port_vision_head(ck, "gen_head.", cfg.dtype),
        "gen_embed": ck.get("gen_embed.weight", cfg.dtype),
    }
    return janus_lib.JanusModel(cfg, params, device)
