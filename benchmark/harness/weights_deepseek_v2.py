"""Seeded random weights of a Janus model on a DeepSeek-V2 trunk, HF-keyed,
made on the device.

The trunk's keys and shapes are those of DeepSeek-V2's published state dict
(``modeling_deepseek``: MLA projections, the router ``mlp.gate``, routed
experts ``mlp.experts.{e}.*``, ``mlp.shared_experts.*``, the first
``first_k_dense_replace`` layers' dense ``mlp.*``), worked out from the
configuration's ``language_config``; the generation side is
``harness.weights``' own keys.  Values and filling are ``harness.weights``':
matrices ``N(0, fan_in ** -0.5)``, norm scales ones, all bf16, every normal
tensor a view of one flat buffer filled by one ``normal_`` call.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Sequence

import torch

from harness import weights as base
from harness.weights import Key, _lin, _norm


def language_keys(lc: dict) -> Iterator[Key]:
    h, v = lc["hidden_size"], lc["vocab_size"]
    heads, R = lc["num_attention_heads"], lc["kv_lora_rank"]
    dn, dr, dv = lc["qk_nope_head_dim"], lc["qk_rope_head_dim"], lc["v_head_dim"]
    E, fe = lc["n_routed_experts"], lc["moe_intermediate_size"]
    pre = "language_model.model."
    yield pre + "embed_tokens.weight", (v, h), "normal"

    def mlp(b: str, width: int) -> Iterator[Key]:
        yield from _lin(b + "gate_proj", width, h, bias=False)
        yield from _lin(b + "up_proj", width, h, bias=False)
        yield from _lin(b + "down_proj", h, width, bias=False)

    for i in range(lc["num_hidden_layers"]):
        b = f"{pre}layers.{i}."
        yield from _norm(b + "input_layernorm", h, bias=False)
        yield from _lin(b + "self_attn.q_proj", heads * (dn + dr), h, bias=False)
        yield from _lin(b + "self_attn.kv_a_proj_with_mqa", R + dr, h, bias=False)
        yield from _norm(b + "self_attn.kv_a_layernorm", R, bias=False)
        yield from _lin(b + "self_attn.kv_b_proj", heads * (dn + dv), R, bias=False)
        yield from _lin(b + "self_attn.o_proj", h, heads * dv, bias=False)
        yield from _norm(b + "post_attention_layernorm", h, bias=False)
        if i < lc.get("first_k_dense_replace", 0):
            yield from mlp(b + "mlp.", lc["intermediate_size"])
            continue
        yield from _lin(b + "mlp.gate", E, h, bias=False)
        for e in range(E):
            yield from mlp(f"{b}mlp.experts.{e}.", fe)
        if lc.get("n_shared_experts"):
            yield from mlp(b + "mlp.shared_experts.", fe * lc["n_shared_experts"])
    yield from _norm(pre + "norm", h, bias=False)


PARTS = {**base.PARTS, "language": lambda c: language_keys(c["language_config"])}


def make_weights(cfg: dict, parts: Sequence[str], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every key of ``parts`` → a bf16 tensor on ``device``, from ``seed``
    (``harness.weights.make_weights`` over this trunk's keys)."""
    keys = [k for part in parts for k in PARTS[part](cfg)]
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
            t.mul_(base._fan_in(shape) ** -0.5)
            off += n
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            t = fill(shape, dtype=torch.bfloat16, device=device)
        out[key] = t
    return out
