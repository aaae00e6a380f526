"""Seeded random weights of a Janus model on a Kimi Linear trunk, HF-keyed,
made on the device.

The trunk's keys and shapes are those the configuration's ``assumed.hf_keys``
names (``self_attn.*`` of the Kimi Delta Attention and MLA layers,
``mlp.*`` of the dense first layer, ``block_sparse_moe.gate`` with its
``e_score_correction_bias``, routed experts ``block_sparse_moe.experts.{e}.
w1/w3/w2`` and ``block_sparse_moe.shared_experts.*``), worked out from the
configuration's ``language_config``: the router scores every expert of the
share's ``expert_parallel.experts``, and only the ``num_experts`` held
experts from ``first_held`` on are made.  The generation side is
``harness.weights``' own keys.  Values: matrices and the convs ``N(0,
fan_in ** -0.5)`` from one flat buffer filled by one ``normal_`` call
(``harness.weights``' filling); the RMSNorm and ``o_norm`` scales 1;
``A_log`` the log of U(1, 16) a head, ``dt_bias`` the inverse softplus of
``exp(U(log 0.001, log 0.1))`` a channel and the correction bias ``0.05 ·
N(0, 1)`` an expert, drawn after the normal buffer from the same generator.
All bf16 but the correction bias, fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Sequence

import torch

from harness import weights as base
from harness.weights import Key, _lin, _norm

BIAS_STD = 0.05


def language_keys(lc: dict) -> Iterator[Key]:
    h, v = lc["hidden_size"], lc["vocab_size"]
    la = lc["linear_attn_config"]
    H, D, K = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    Hm, dn, dr = lc["num_attention_heads"], lc["qk_nope_head_dim"], lc["qk_rope_head_dim"]
    R, dv = lc["kv_lora_rank"], lc["v_head_dim"]
    ep = lc.get("expert_parallel") or {}
    held, e0 = lc["num_experts"], ep.get("first_held", 0)
    routed = ep.get("experts", held)
    fe = lc["moe_intermediate_size"]
    pre = "language_model.model."
    yield pre + "embed_tokens.weight", (v, h), "normal"

    def mlp(b: str, names, width: int) -> Iterator[Key]:
        g, u, d = names
        yield from _lin(b + g, width, h, bias=False)
        yield from _lin(b + u, width, h, bias=False)
        yield from _lin(b + d, h, width, bias=False)

    plain = ("gate_proj", "up_proj", "down_proj")
    for i in range(lc["num_hidden_layers"]):
        b = f"{pre}layers.{i}."
        a = b + "self_attn."
        yield from _norm(b + "input_layernorm", h, bias=False)
        if i + 1 in la["kda_layers"]:
            for n in "qkv":
                yield from _lin(a + f"{n}_proj", H * D, h, bias=False)
                yield a + f"{n}_conv1d.weight", (H * D, 1, K), "normal"
            yield from _lin(a + "f_a_proj", D, h, bias=False)
            yield from _lin(a + "f_b_proj", H * D, D, bias=False)
            yield from _lin(a + "g_a_proj", D, h, bias=False)
            yield from _lin(a + "g_b_proj", H * D, D, bias=False)
            yield from _lin(a + "b_proj", H, h, bias=False)
            yield a + "A_log", (H,), "a_log"
            yield a + "dt_bias", (H * D,), "dt_bias"
            yield from _norm(a + "o_norm", D, bias=False)
            yield from _lin(a + "o_proj", h, H * D, bias=False)
        else:
            yield from _lin(a + "q_proj", Hm * (dn + dr), h, bias=False)
            yield from _lin(a + "kv_a_proj_with_mqa", R + dr, h, bias=False)
            yield from _norm(a + "kv_a_layernorm", R, bias=False)
            yield from _lin(a + "kv_b_proj", Hm * (dn + dv), R, bias=False)
            yield from _lin(a + "o_proj", h, Hm * dv, bias=False)
        yield from _norm(b + "post_attention_layernorm", h, bias=False)
        if i < lc["first_k_dense_replace"]:
            yield from mlp(b + "mlp.", plain, lc["intermediate_size"])
            continue
        m = b + "block_sparse_moe."
        yield from _lin(m + "gate", routed, h, bias=False)
        yield m + "gate.e_score_correction_bias", (routed,), "correction"
        for e in range(e0, e0 + held):
            yield from mlp(f"{m}experts.{e}.", ("w1", "w3", "w2"), fe)
        yield from mlp(m + "shared_experts.", plain, fe * lc["num_shared_experts"])
    yield from _norm(pre + "norm", h, bias=False)


PARTS = {**base.PARTS, "language": lambda c: language_keys(c["language_config"])}


def make_weights(cfg: dict, parts: Sequence[str], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every key of ``parts`` → a tensor on ``device``, from ``seed``."""
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
        elif kind == "a_log":
            u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
            t = torch.log(1.0 + 15.0 * u).to(torch.bfloat16)
        elif kind == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
            dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u)
            t = (dt + torch.log(-torch.expm1(-dt))).to(torch.bfloat16)
        elif kind == "correction":
            t = BIAS_STD * torch.randn(shape, generator=gen, device=device,
                                       dtype=torch.float32)
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            t = fill(shape, dtype=torch.bfloat16, device=device)
        out[key] = t
    return out
