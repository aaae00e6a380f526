"""Seeded random weights of a Janus model on a Qwen3-Next trunk, HF-keyed,
made on the device.

The trunk's keys and shapes are those of Qwen3-Next's published state dict
(``modeling_qwen3_next``: ``linear_attn.*`` of the Gated DeltaNet layers,
``self_attn.*`` of the full-attention layers, the router ``mlp.gate``,
routed experts ``mlp.experts.{e}.*``, ``mlp.shared_expert.*`` and its gate
``mlp.shared_expert_gate``), worked out from the configuration's
``language_config``: the router scores every expert of the share's
``expert_parallel.experts``, and only the ``num_experts`` held experts from
``first_held`` on are made.  The generation side is ``harness.weights``'
own keys.  Values: matrices and the conv ``N(0, fan_in ** -0.5)`` from
one flat buffer filled by one ``normal_`` call (``harness.weights``'
filling); the zero-centred norms' offsets 0; the gated norms' scales 1;
``A_log`` the log of U(1, 16) and ``dt_bias`` the inverse softplus of
``exp(U(log 0.001, log 0.1))``, drawn after the normal buffer from the same
generator.  All bf16.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Sequence

import torch

from harness import weights as base
from harness.weights import Key, _lin, _norm


def language_keys(lc: dict) -> Iterator[Key]:
    h, v = lc["hidden_size"], lc["vocab_size"]
    H, Hkv, D = lc["num_attention_heads"], lc["num_key_value_heads"], lc["head_dim"]
    hk, hv = lc["linear_num_key_heads"], lc["linear_num_value_heads"]
    dk, dv, K = lc["linear_key_head_dim"], lc["linear_value_head_dim"], \
        lc["linear_conv_kernel_dim"]
    ep = lc.get("expert_parallel") or {}
    held, e0 = lc["num_experts"], ep.get("first_held", 0)
    routed = ep.get("experts", held)
    fe, fs = lc["moe_intermediate_size"], lc["shared_expert_intermediate_size"]
    pre = "language_model.model."
    yield pre + "embed_tokens.weight", (v, h), "normal"

    def mlp(b: str, width: int) -> Iterator[Key]:
        yield from _lin(b + "gate_proj", width, h, bias=False)
        yield from _lin(b + "up_proj", width, h, bias=False)
        yield from _lin(b + "down_proj", h, width, bias=False)

    for i in range(lc["num_hidden_layers"]):
        b = f"{pre}layers.{i}."
        yield b + "input_layernorm.weight", (h,), "zeros"
        if (i + 1) % lc["full_attention_interval"] == 0:
            a = b + "self_attn."
            yield from _lin(a + "q_proj", 2 * H * D, h, bias=False)
            yield from _lin(a + "k_proj", Hkv * D, h, bias=False)
            yield from _lin(a + "v_proj", Hkv * D, h, bias=False)
            yield from _lin(a + "o_proj", h, H * D, bias=False)
            yield a + "q_norm.weight", (D,), "zeros"
            yield a + "k_norm.weight", (D,), "zeros"
        else:
            a = b + "linear_attn."
            yield from _lin(a + "in_proj_qkvz", 2 * hk * dk + 2 * hv * dv, h, bias=False)
            yield from _lin(a + "in_proj_ba", 2 * hv, h, bias=False)
            yield a + "conv1d.weight", (2 * hk * dk + hv * dv, 1, K), "normal"
            yield a + "dt_bias", (hv,), "dt_bias"
            yield a + "A_log", (hv,), "a_log"
            yield from _norm(a + "norm", dv, bias=False)
            yield from _lin(a + "out_proj", h, hv * dv, bias=False)
        yield b + "post_attention_layernorm.weight", (h,), "zeros"
        yield from _lin(b + "mlp.gate", routed, h, bias=False)
        for e in range(e0, e0 + held):
            yield from mlp(f"{b}mlp.experts.{e}.", fe)
        yield from mlp(b + "mlp.shared_expert.", fs)
        yield from _lin(b + "mlp.shared_expert_gate", 1, h, bias=False)
    yield pre + "norm.weight", (h,), "zeros"


PARTS = {**base.PARTS, "language": lambda c: language_keys(c["language_config"])}


def make_weights(cfg: dict, parts: Sequence[str], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every key of ``parts`` → a bf16 tensor on ``device``, from ``seed``."""
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
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            t = fill(shape, dtype=torch.bfloat16, device=device)
        out[key] = t
    return out
