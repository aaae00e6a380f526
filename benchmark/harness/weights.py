"""Seeded random Janus-Pro weights, HF-keyed, made on the device.

The keys and shapes are those of the published Janus-Pro state dict (the
language model in DeepSeek-LLM layout, the VQ-16 tokenizer, the generation
aligner and head, the SigLIP tower and its aligner), worked out here from the
configuration file alone.  Values: projection and embedding matrices
``N(0, fan_in ** -0.5)``, norm scales ones, biases zeros, all bf16.

Every normal tensor of one call is a view of one flat buffer filled by one
``normal_`` call on the device and scaled in place, so 7B takes a few calls
and no host memory.  The same (config, parts, seed, device) gives the same
tensors, which is how the program and the reference are handed the same
weights without either seeing what the other made of them.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Sequence, Tuple

import torch

Key = Tuple[str, Tuple[int, ...], str]


def _lin(name: str, cout: int, cin: int, bias: bool = True) -> Iterator[Key]:
    yield name + ".weight", (cout, cin), "normal"
    if bias:
        yield name + ".bias", (cout,), "zeros"


def _norm(name: str, ch: int, bias: bool = True) -> Iterator[Key]:
    yield name + ".weight", (ch,), "ones"
    if bias:
        yield name + ".bias", (ch,), "zeros"


def _conv(name: str, cout: int, cin: int, k: int) -> Iterator[Key]:
    yield name + ".weight", (cout, cin, k, k), "normal"
    yield name + ".bias", (cout,), "zeros"


def language_keys(lc: dict, lm_head: bool) -> Iterator[Key]:
    h, f, v = lc["hidden_size"], lc["intermediate_size"], lc["vocab_size"]
    heads = lc["num_attention_heads"]
    kvh = lc.get("num_key_value_heads") or heads
    dh = h // heads
    pre = "language_model.model."
    yield pre + "embed_tokens.weight", (v, h), "normal"
    for i in range(lc["num_hidden_layers"]):
        b = f"{pre}layers.{i}."
        yield from _norm(b + "input_layernorm", h, bias=False)
        yield from _lin(b + "self_attn.q_proj", heads * dh, h, bias=False)
        yield from _lin(b + "self_attn.k_proj", kvh * dh, h, bias=False)
        yield from _lin(b + "self_attn.v_proj", kvh * dh, h, bias=False)
        yield from _lin(b + "self_attn.o_proj", h, heads * dh, bias=False)
        yield from _norm(b + "post_attention_layernorm", h, bias=False)
        yield from _lin(b + "mlp.gate_proj", f, h, bias=False)
        yield from _lin(b + "mlp.up_proj", f, h, bias=False)
        yield from _lin(b + "mlp.down_proj", h, f, bias=False)
    yield from _norm(pre + "norm", h, bias=False)
    if lm_head:
        yield from _lin("language_model.lm_head", v, h, bias=False)


def _res(name: str, cin: int, cout: int) -> Iterator[Key]:
    yield from _norm(name + ".norm1", cin)
    yield from _conv(name + ".conv1", cout, cin, 3)
    yield from _norm(name + ".norm2", cout)
    yield from _conv(name + ".conv2", cout, cout, 3)
    if cin != cout:
        yield from _conv(name + ".nin_shortcut", cout, cin, 1)


def _attn(name: str, ch: int) -> Iterator[Key]:
    yield from _norm(name + ".norm", ch)
    for part in ("q", "k", "v", "proj_out"):
        yield from _conv(f"{name}.{part}", ch, ch, 1)


def vq_keys(vq: dict) -> Iterator[Key]:
    """VQ-16 (LlamaGen's ``VQModel``): encoder, decoder, codebook, the two
    1x1 convolutions around the codebook."""
    ch, mult, z = vq["base_ch"], vq["ch_mult"], vq["z_channels"]
    n, nres = len(mult), vq["num_res_blocks"]
    pre = "gen_vision_model."
    yield from _conv(pre + "encoder.conv_in", ch, 3, 3)
    cin = ch
    for i in range(n):
        cout = ch * mult[i]
        for j in range(nres):
            yield from _res(f"{pre}encoder.conv_blocks.{i}.res.{j}", cin, cout)
            cin = cout
            if i == n - 1:
                yield from _attn(f"{pre}encoder.conv_blocks.{i}.attn.{j}", cin)
        if i != n - 1:
            yield from _conv(f"{pre}encoder.conv_blocks.{i}.downsample.conv",
                             cin, cin, 3)
    for m in ("0", "1", "2"):
        yield from (_attn if m == "1" else
                    lambda nm, c: _res(nm, c, c))(pre + "encoder.mid." + m, cin)
    yield from _norm(pre + "encoder.norm_out", cin)
    yield from _conv(pre + "encoder.conv_out", z, cin, 3)

    top = ch * mult[-1]
    yield from _conv(pre + "decoder.conv_in", top, z, 3)
    for m in ("0", "1", "2"):
        yield from (_attn if m == "1" else
                    lambda nm, c: _res(nm, c, c))(pre + "decoder.mid." + m, top)
    cin = top
    for bi, level in enumerate(reversed(range(n))):
        cout = ch * mult[level]
        for j in range(nres + 1):
            yield from _res(f"{pre}decoder.conv_blocks.{bi}.res.{j}", cin, cout)
            cin = cout
            if level == n - 1:
                yield from _attn(f"{pre}decoder.conv_blocks.{bi}.attn.{j}", cin)
        if level != 0:
            yield from _conv(f"{pre}decoder.conv_blocks.{bi}.upsample.conv",
                             cin, cin, 3)
    yield from _norm(pre + "decoder.norm_out", cin)
    yield from _conv(pre + "decoder.conv_out", 3, cin, 3)
    yield (pre + "quantize.embedding.weight",
           (vq["codebook_size"], vq["codebook_dim"]), "normal")
    yield from _conv(pre + "quant_conv", vq["codebook_dim"], z, 1)
    yield from _conv(pre + "post_quant_conv", z, vq["codebook_dim"], 1)


def _mlp_gelu(prefix: str, depth: int, d_in: int, d_out: int) -> Iterator[Key]:
    for d in range(depth):
        yield from _lin(f"{prefix}layers.{0 if d == 0 else 2 * d}",
                        d_out, d_in if d == 0 else d_out)


def generation_keys(cfg: dict) -> Iterator[Key]:
    e = cfg["language_config"]["hidden_size"]
    g = cfg["gen_vision_config"]["params"]
    yield from vq_keys(g["vq"])
    yield from _mlp_gelu("gen_aligner.", cfg["gen_aligner_config"]["params"]["depth"],
                         g["n_embed"], e)
    yield from _lin("gen_head.output_mlp_projector", e, e)
    yield from _lin("gen_head.vision_head", g["image_token_size"], e)
    yield "gen_embed.weight", (g["image_token_size"], g["n_embed"]), "normal"


def understanding_keys(cfg: dict) -> Iterator[Key]:
    """The SigLIP tower (all its layers, with the attention-pool head) and
    the understanding aligner."""
    vp = cfg["vision_config"]["params"]
    w, p, depth = vp["width"], vp["patch_size"], vp["layers"]
    hid = int(w * vp["mlp_ratio"])
    n_patch = (vp["image_size"] // p) ** 2
    pre = "vision_model.vision_tower."
    yield pre + "patch_embed.proj.weight", (w, 3, p, p), "normal"
    yield pre + "patch_embed.proj.bias", (w,), "zeros"
    yield pre + "pos_embed", (1, n_patch, w), "normal"
    for i in range(depth):
        b = f"{pre}blocks.{i}."
        yield from _norm(b + "norm1", w)
        yield from _lin(b + "attn.qkv", 3 * w, w)
        yield from _lin(b + "attn.proj", w, w)
        yield from _norm(b + "norm2", w)
        yield from _lin(b + "mlp.fc1", hid, w)
        yield from _lin(b + "mlp.fc2", w, hid)
    yield from _norm(pre + "norm", w)
    ap = pre + "attn_pool."
    yield ap + "latent", (1, 1, w), "normal"
    yield from _lin(ap + "q", w, w)
    yield from _lin(ap + "kv", 2 * w, w)
    yield from _lin(ap + "proj", w, w)
    yield from _norm(ap + "norm", w)
    yield from _lin(ap + "mlp.fc1", hid, w)
    yield from _lin(ap + "mlp.fc2", w, hid)
    yield from _mlp_gelu("aligner.", cfg["aligner_config"]["params"]["depth"],
                         w, cfg["language_config"]["hidden_size"])


PARTS = {"language": lambda c: language_keys(c["language_config"], False),
         "lm_head": lambda c: _lin("language_model.lm_head",
                                   c["language_config"]["vocab_size"],
                                   c["language_config"]["hidden_size"], False),
         "generation": generation_keys,
         "understanding": understanding_keys}


def key_shapes(cfg: dict, parts: Sequence[str]) -> Iterator[Key]:
    for part in parts:
        yield from PARTS[part](cfg)


def _fan_in(shape: Tuple[int, ...]) -> int:
    return shape[-1] if len(shape) <= 2 else math.prod(shape[1:])


def make_weights(cfg: dict, parts: Sequence[str], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every key of ``parts`` → a bf16 tensor on ``device``, from ``seed``."""
    keys = list(key_shapes(cfg, parts))
    total = sum(math.prod(s) for _, s, kind in keys if kind == "normal")
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat.normal_(0.0, 1.0, generator=gen)
    out, off = {}, 0
    for key, shape, kind in keys:
        if kind == "normal":
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            t.mul_(_fan_in(shape) ** -0.5)
            off += n
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            t = fill(shape, dtype=torch.bfloat16, device=device)
        out[key] = t
    return out
