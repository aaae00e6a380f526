"""The route of a cached T > 1 step over the batch-minor cache
(``ops/suffix_attention.py``), on the CPU.

On the card a bf16 step over an ``shbd`` MHA cache with an int8 or bf16
payload runs the kernel ``csrc/suffix_attention.cu``
(``tests/test_torch_cuda.py`` holds it against the plain version there);
everything else keeps the plain ``xla_attention``.  Here: the route from
the input alone, the plain version against the forward's own read, and the
tolerance the kernel is held to, on a model of its one extra rounding.
"""

from types import SimpleNamespace

import pytest
import torch

import suffix_attention_reference as sref
from ospo_tpu_torch.models import llama
from ospo_tpu_torch.ops import suffix_attention as sa
from ospo_tpu_torch.ops.attention import xla_attention
from ospo_tpu_torch.utils.profiling import kernel_launches


def _card_like(shape, dtype=torch.bfloat16, device="cuda"):
    """A stand-in with the attributes the route reads: a card tensor is not
    at hand on the CPU."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype, shape=shape)


# step 4b's slice at 1B: 8 images, 16 heads, a suffix of 240 rows after 640
CELL = dict(B=8, T=240, H=16, S=880, L=24)


def _route(q_kw=None, cache_kw=None, int8=True, prefix=True, per_row=False,
           prefix_dtype=torch.bfloat16):
    B, T, H, S, L = (CELL[k] for k in "BTHSL")
    q = _card_like(**{"shape": (B, T, H, 128), **(q_kw or {})})
    ckw = {"heads": H, "dtype": torch.int8 if int8 else torch.bfloat16,
           "layout": "shbd", "scale_heads": H, "device": "cuda", **(cache_kw or {})}
    kv_shape = (L, S, ckw["heads"], B, 128)
    cache = {"layout": ckw["layout"],
             "k": _card_like(kv_shape, ckw["dtype"], ckw["device"])}
    if int8:
        cache["k_s"] = _card_like((L, S, ckw["scale_heads"], B), torch.float32)
    pk = _card_like((48, H, 128), prefix_dtype) if prefix else None
    return sa.suffix_attention_takes(q, cache, per_row, pk)


@pytest.mark.parametrize("kw,takes", [
    ({}, True),                                               # the cell's step
    ({"prefix": False}, True),                                # no pre-image segment
    ({"int8": False}, True),                                  # a bf16 payload
    ({"q_kw": {"shape": (8, 16, 16, 128)}}, True),            # a short suffix
    ({"q_kw": {"device": "cpu"}}, False),
    ({"cache_kw": {"layout": "bshd"}}, False),
    ({"cache_kw": {"layout": "bhsd"}}, False),
    ({"cache_kw": {"heads": 8}}, False),                       # int4: head pairs
    ({"q_kw": {"shape": (8, 1, 16, 128)}}, False),            # T = 1: decode kernel
    ({"cache_kw": {"heads": 4, "scale_heads": 4}}, False),     # GQA
    ({"q_kw": {"shape": (8, 240, 16, 64)}}, False),           # head dim 64
    ({"per_row": True}, False),                               # per-row offsets
    ({"q_kw": {"dtype": torch.float32}}, False),
    ({"cache_kw": {"dtype": torch.float32}, "int8": False}, False),
    ({"prefix_dtype": torch.float32}, False),
    ({"cache_kw": {"device": "cuda:1"}}, False),
])
def test_the_route_follows_from_the_input(kw, takes):
    """bf16 queries on the card, T > 1, head dim 128, one offset for every
    row, an ``shbd`` MHA cache with an int8 (scaled) or bf16 payload and a
    bf16 prefix take the kernel; the CPU, ``bshd``, ``bhsd``, int4, T = 1,
    GQA, another head dim, per-row offsets and fp32 keep the plain form."""
    assert _route(**kw) is takes


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("C,pm", [(0, None), (16, "shared"), (16, "per_image")])
def test_cpu_step_takes_the_plain_form(kind, C, pm):
    """On the CPU the wrapper is the forward's plain read (``xla_attention``
    over the window) bit for bit, and no kernel's launch count moves."""
    a = sref.suffix_inputs(3, 24, 2, 70, C, kind, seed=C + len(kind), device="cpu",
                           prefix_mask=pm or "shared")
    n0 = kernel_launches()
    got = sref.call(sa.suffix_attention, a)
    cache = {"k": a["k_cache"], "v": a["v_cache"], "layout": "shbd"}
    if kind == "int8":
        cache.update(k_s=a["k_scale"], v_s=a["v_scale"])
    window = a["cur_len"] + a["q"].shape[1]
    k, v = llama._cache_window(cache, 1, "shbd", window)
    ref = xla_attention(a["q"], k, v, a["mask"][:, :window], a["cur_len"], True,
                        a.get("prefix_k"), a.get("prefix_v"), a.get("prefix_mask"),
                        kv_layout="shbd")
    assert torch.equal(got, ref)
    assert kernel_launches() == n0


@pytest.mark.parametrize("C,pm", [(0, None), (48, "shared"), (48, "per_image")])
def test_the_tolerance_takes_fp16_p_and_refuses_the_controls(C, pm):
    """The tolerance the card tests hold the kernel to admits the plain
    version with ``p * v_scale / f`` rounded to fp16 (the kernel's one extra
    rounding) with room, and refuses each control by 10x or more: one
    image's k scales times 1 + 2^-7, the prefix dropped, the causal limit a
    row lower."""
    torch.manual_seed(0)
    a = sref.suffix_inputs(3, 96, 2, 320, C, "int8", seed=7, device="cpu",
                           prefix_mask=pm or "shared")
    ref, tol = sref.call(sref.plain_and_tolerance, a)
    assert sref.worst(sref.call(sref.fp16_p_model, a), ref, tol) < 0.5
    for name, change in sref.controls(a).items():
        got = sref.call(sa.suffix_attention_plain, a, **change)
        assert sref.worst(got, ref, tol) >= 10, name


def test_a_row_without_an_allowed_key_averages_the_window():
    """The plain semantics the kernel keeps: image 1's first suffix rows
    (no allowed own key, its prefix row masked) get the mean of V over the
    prefix and the whole window, causally disallowed rows included."""
    a = sref.suffix_inputs(3, 24, 2, 70, 16, "bf16", seed=3, device="cpu",
                           prefix_mask="per_image")
    out = sref.call(sa.suffix_attention_plain, a, q=a["q"].float())
    window = a["cur_len"] + 24
    own = a["v_cache"][1, :window, :, 1].float()                   # [W, H, dh]
    mean = torch.cat([a["prefix_v"].float(), own]).mean(0)        # [H, dh]
    for t in range(5):
        torch.testing.assert_close(out[1, t], mean, rtol=1e-5, atol=1e-6)
