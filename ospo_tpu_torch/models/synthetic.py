"""Synthetic HF-layout Janus checkpoints at any width, full 7B included —
the port's copy of ``ospo_tpu/models/synthetic.py``.

Writes ``config.json`` (marked ``ospo_synthetic``: a tokenizer-less
checkpoint, for which the tokenizer falls back to bytes) and sharded bf16
``*.safetensors`` with the key names and shapes of the real Janus-Pro state
dict, through the port's own safetensors writer.  Values are drawn as the
JAX package draws them (one CPU ``torch.Generator`` seeded with ``seed``,
``normal_(0, fan_in ** -0.5)`` on bf16 tensors in key order; norm scales
ones, biases zeros), so both packages write the same bytes for one
configuration and seed.  Host code: it computes nothing on a device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.utils.safetensors_io import save_file


def _llama_shapes(lc) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    h, inter, vocab = lc.hidden_size, lc.intermediate_size, lc.vocab_size
    pre = "language_model."
    yield pre + "model.embed_tokens.weight", (vocab, h), "normal"
    for i in range(lc.num_layers):
        b = f"{pre}model.layers.{i}."
        yield b + "input_layernorm.weight", (h,), "ones"
        for proj in ("q", "k", "v", "o"):
            yield b + f"self_attn.{proj}_proj.weight", (h, h), "normal"
        yield b + "post_attention_layernorm.weight", (h,), "ones"
        yield b + "mlp.gate_proj.weight", (inter, h), "normal"
        yield b + "mlp.up_proj.weight", (inter, h), "normal"
        yield b + "mlp.down_proj.weight", (h, inter), "normal"
    yield pre + "model.norm.weight", (h,), "ones"
    yield pre + "lm_head.weight", (vocab, h), "normal"


def _vit_shapes(vc) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    w, hid = vc.width, vc.mlp_hidden
    pre = "vision_model.vision_tower."
    yield pre + "patch_embed.proj.weight", (w, 3, vc.patch_size, vc.patch_size), "normal"
    yield pre + "patch_embed.proj.bias", (w,), "zeros"
    yield pre + "pos_embed", (1, vc.num_patches, w), "normal"
    for i in range(vc.layers):  # checkpoints carry ALL layers pre-truncation
        b = f"{pre}blocks.{i}."
        yield b + "norm1.weight", (w,), "ones"
        yield b + "norm1.bias", (w,), "zeros"
        yield b + "attn.qkv.weight", (3 * w, w), "normal"
        yield b + "attn.qkv.bias", (3 * w,), "zeros"
        yield b + "attn.proj.weight", (w, w), "normal"
        yield b + "attn.proj.bias", (w,), "zeros"
        yield b + "norm2.weight", (w,), "ones"
        yield b + "norm2.bias", (w,), "zeros"
        yield b + "mlp.fc1.weight", (hid, w), "normal"
        yield b + "mlp.fc1.bias", (hid,), "zeros"
        yield b + "mlp.fc2.weight", (w, hid), "normal"
        yield b + "mlp.fc2.bias", (w,), "zeros"
    yield pre + "norm.weight", (w,), "ones"
    yield pre + "norm.bias", (w,), "zeros"
    # latent attention-pool head (global_pool="map", siglip_vit.py:415-422)
    ap = pre + "attn_pool."
    yield ap + "latent", (1, 1, w), "normal"
    yield ap + "q.weight", (w, w), "normal"
    yield ap + "q.bias", (w,), "zeros"
    yield ap + "kv.weight", (2 * w, w), "normal"
    yield ap + "kv.bias", (2 * w,), "zeros"
    yield ap + "proj.weight", (w, w), "normal"
    yield ap + "proj.bias", (w,), "zeros"
    yield ap + "norm.weight", (w,), "ones"
    yield ap + "norm.bias", (w,), "zeros"
    yield ap + "mlp.fc1.weight", (hid, w), "normal"
    yield ap + "mlp.fc1.bias", (hid,), "zeros"
    yield ap + "mlp.fc2.weight", (w, hid), "normal"
    yield ap + "mlp.fc2.bias", (w,), "zeros"


def _conv_keys(name, cout, cin, k) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    yield name + ".weight", (cout, cin, k, k), "normal"
    yield name + ".bias", (cout,), "zeros"


def _gn_keys(name, ch) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    yield name + ".weight", (ch,), "ones"
    yield name + ".bias", (ch,), "zeros"


def _res_keys(name, cin, cout):
    yield from _gn_keys(name + ".norm1", cin)
    yield from _conv_keys(name + ".conv1", cout, cin, 3)
    yield from _gn_keys(name + ".norm2", cout)
    yield from _conv_keys(name + ".conv2", cout, cout, 3)
    if cin != cout:
        yield from _conv_keys(name + ".nin_shortcut", cout, cin, 1)


def _attn_keys(name, ch):
    yield from _gn_keys(name + ".norm", ch)
    for q in ("q", "k", "v", "proj_out"):
        yield from _conv_keys(name + "." + q, ch, ch, 1)


def _vq_shapes(vq) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """Mirrors Encoder/Decoder wiring of vq_model.py:46-214."""
    ch, mult, z = vq.base_ch, vq.ch_mult, vq.z_channels
    n_levels, n_res = len(mult), vq.num_res_blocks
    pre = "gen_vision_model."
    in_mult = (1,) + tuple(mult)

    yield from _conv_keys(pre + "encoder.conv_in", ch, 3, 3)
    block_in = ch
    for i in range(n_levels):
        block_in = ch * in_mult[i]
        block_out = ch * mult[i]
        for j in range(n_res):
            yield from _res_keys(f"{pre}encoder.conv_blocks.{i}.res.{j}",
                                 block_in, block_out)
            block_in = block_out
            if i == n_levels - 1:
                yield from _attn_keys(
                    f"{pre}encoder.conv_blocks.{i}.attn.{j}", block_in)
        if i != n_levels - 1:
            yield from _conv_keys(
                f"{pre}encoder.conv_blocks.{i}.downsample.conv",
                block_in, block_in, 3)
    for m, is_attn in (("0", False), ("1", True), ("2", False)):
        if is_attn:
            yield from _attn_keys(pre + "encoder.mid." + m, block_in)
        else:
            yield from _res_keys(pre + "encoder.mid." + m, block_in, block_in)
    yield from _gn_keys(pre + "encoder.norm_out", block_in)
    yield from _conv_keys(pre + "encoder.conv_out", z, block_in, 3)

    top = ch * mult[-1]
    yield from _conv_keys(pre + "decoder.conv_in", top, z, 3)
    for m, is_attn in (("0", False), ("1", True), ("2", False)):
        if is_attn:
            yield from _attn_keys(pre + "decoder.mid." + m, top)
        else:
            yield from _res_keys(pre + "decoder.mid." + m, top, top)
    block_in = top
    for bi, i_level in enumerate(reversed(range(n_levels))):
        block_out = ch * mult[i_level]
        for j in range(n_res + 1):
            yield from _res_keys(f"{pre}decoder.conv_blocks.{bi}.res.{j}",
                                 block_in, block_out)
            block_in = block_out
            if i_level == n_levels - 1:
                yield from _attn_keys(
                    f"{pre}decoder.conv_blocks.{bi}.attn.{j}", block_in)
        if i_level != 0:
            yield from _conv_keys(
                f"{pre}decoder.conv_blocks.{bi}.upsample.conv",
                block_in, block_in, 3)
    yield from _gn_keys(pre + "decoder.norm_out", block_in)
    yield from _conv_keys(pre + "decoder.conv_out", 3, block_in, 3)

    yield pre + "quantize.embedding.weight", (vq.codebook_size, vq.codebook_dim), "normal"
    yield from _conv_keys(pre + "quant_conv", vq.codebook_dim, z, 1)
    yield from _conv_keys(pre + "post_quant_conv", z, vq.codebook_dim, 1)


def _projector_shapes(prefix, depth, d_in, d_out):
    for d in range(depth):
        idx = 0 if d == 0 else 2 * d
        src = d_in if d == 0 else d_out
        yield f"{prefix}layers.{idx}.weight", (d_out, src), "normal"
        yield f"{prefix}layers.{idx}.bias", (d_out,), "zeros"


def janus_key_shapes(cfg: janus_lib.JanusConfig):
    """Every (key, shape, init) of the HF Janus state dict for ``cfg``."""
    yield from _llama_shapes(cfg.language)
    yield from _vit_shapes(cfg.vision)
    yield from _vq_shapes(cfg.vq)
    yield from _projector_shapes("aligner.", cfg.aligner_depth,
                                 cfg.vision.width, cfg.n_embed)
    yield from _projector_shapes("gen_aligner.", cfg.gen_aligner_depth,
                                 cfg.gen_embed_dim, cfg.n_embed)
    yield "gen_head.output_mlp_projector.weight", (cfg.n_embed, cfg.n_embed), "normal"
    yield "gen_head.output_mlp_projector.bias", (cfg.n_embed,), "zeros"
    yield "gen_head.vision_head.weight", (cfg.image_token_size, cfg.n_embed), "normal"
    yield "gen_head.vision_head.bias", (cfg.image_token_size,), "zeros"
    yield "gen_embed.weight", (cfg.image_token_size, cfg.gen_embed_dim), "normal"


def _hf_config(cfg) -> Dict:
    lc = cfg.language
    model_name = ("siglip_so400m_patch14_384" if cfg.vision.patch_size == 14
                  else "siglip_large_patch16_384")
    return {
        "model_type": "multi_modality",
        "language_config": {
            "vocab_size": lc.vocab_size,
            "hidden_size": lc.hidden_size,
            "intermediate_size": lc.intermediate_size,
            "num_hidden_layers": lc.num_layers,
            "num_attention_heads": lc.num_heads,
            "num_key_value_heads": lc.num_kv_heads or lc.num_heads,
            "rope_theta": lc.rope_theta,
            "rms_norm_eps": lc.rms_norm_eps,
            "max_position_embeddings": lc.max_seq_len,
        },
        # explicit shape params beyond the reference's model_name registry
        # so NON-standard (tiny/test) checkpoints self-describe; real
        # checkpoints without them fall back to the named preset in
        # weights.config_from_checkpoint
        "vision_config": {"params": {
            "model_name": model_name,
            "image_size": cfg.vision.image_size,
            "select_layer": cfg.vision.select_layer,
            "width": cfg.vision.width,
            "layers": cfg.vision.layers,
            "heads": cfg.vision.heads,
            "patch_size": cfg.vision.patch_size,
            "mlp_ratio": cfg.vision.mlp_ratio,
        }},
        "gen_vision_config": {"params": {
            "n_embed": cfg.gen_embed_dim,
            "image_token_size": cfg.image_token_size,
            "image_size": cfg.gen_image_size,
            "vq": {
                "codebook_size": cfg.vq.codebook_size,
                "codebook_dim": cfg.vq.codebook_dim,
                "base_ch": cfg.vq.base_ch,
                "ch_mult": list(cfg.vq.ch_mult),
                "num_res_blocks": cfg.vq.num_res_blocks,
                "z_channels": cfg.vq.z_channels,
            },
        }},
        "torch_dtype": str(cfg.dtype).removeprefix("torch."),
        "aligner_config": {"params": {"depth": cfg.aligner_depth}},
        "gen_aligner_config": {"params": {"depth": cfg.gen_aligner_depth}},
    }


def synthetic_tensors(cfg: janus_lib.JanusConfig, seed: int = 0
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every (key, bf16 tensor) of the checkpoint for ``cfg`` and ``seed``,
    in key order: what :func:`write_synthetic_checkpoint` writes."""
    gen = torch.Generator().manual_seed(seed)
    for key, shape, init in janus_key_shapes(cfg):
        if init == "ones":
            t = torch.ones(shape, dtype=torch.bfloat16)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=torch.bfloat16)
        else:
            fan_in = shape[-1] if len(shape) <= 2 else int(np.prod(shape[1:]))
            t = torch.empty(shape, dtype=torch.bfloat16)
            t.normal_(0.0, fan_in ** -0.5, generator=gen)
        yield key, t


def write_synthetic_checkpoint(path: str, cfg: janus_lib.JanusConfig,
                               seed: int = 0,
                               shard_bytes: int = 1 << 30) -> str:
    """Write ``config.json`` and ``model-NNNNN.safetensors`` shards for
    ``cfg`` under ``path``; a shard closes once it holds ``shard_bytes``,
    so host memory stays near one shard at the 7B width."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**_hf_config(cfg), "ospo_synthetic": True}, f, indent=2)
    shard: Dict[str, torch.Tensor] = {}
    size = index = 0
    for key, t in synthetic_tensors(cfg, seed):
        shard[key] = t
        size += t.numel() * 2
        if size >= shard_bytes:
            save_file(shard, os.path.join(path, f"model-{index:05d}.safetensors"))
            shard, size, index = {}, 0, index + 1
    if shard:
        save_file(shard, os.path.join(path, f"model-{index:05d}.safetensors"))
    return path
