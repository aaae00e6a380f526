"""The layer tail of ``ops/layer_tail.py`` on the CPU: which cached steps of
``llama.forward`` run its kernels, and its plain forms.

The three kernels run only on the card (``tests/test_torch_cuda.py``).
Here: ``layer_tail.takes`` on stand-ins of card tensors; the forward's own
facts (layout, int4 payload, per-row offsets, GQA, no cache) with ``takes``
forced, so the CPU walks the route with the plain forms; each plain form
against the op chain the forward ran before the kernels, bit for bit; and
the forward on the route, and the image engine's loop over the trunk
graph's buffers on it, against the plain route, bit for bit.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ospo_tpu_torch.models import janus, llama
from ospo_tpu_torch.ops import layer_tail

torch.set_num_threads(2)

CUDA = torch.device("cuda")
TAIL = ("add_rms_norm", "rope_kv_write", "silu_mul")


def _chain_norm(x, w, eps):
    """The norm as the forward ran it before the kernels."""
    xf = x.float()
    rms = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return ((xf * rms).to(x.dtype) * w).to(x.dtype)


def _chain_rope(x, cos, sin):
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# -- the route --------------------------------------------------------------

def _stand_in(device=CUDA, dtype=torch.bfloat16, width=4096, ffn=11008,
              head_dim=128, cache=("int8", True)):
    x = SimpleNamespace(device=device, dtype=dtype, shape=(48, 1, width))
    payload, scales = cache
    kv = {"k": SimpleNamespace(dtype=getattr(torch, payload))}
    if scales:
        kv["k_s"] = SimpleNamespace(dtype=torch.float32)
    return x, kv, head_dim, ffn


@pytest.mark.parametrize("case,kw,want", [
    ("7b int8 cache", {}, True),
    ("1b int8 cache", dict(width=2048, ffn=5632), True),
    ("bf16 cache", dict(cache=("bfloat16", False)), True),
    ("cpu", dict(device=torch.device("cpu")), False),
    ("fp32 activations", dict(dtype=torch.float32), False),
    ("fp16 activations", dict(dtype=torch.float16), False),
    ("head dim 64", dict(head_dim=64), False),
    ("head dim 256", dict(head_dim=256), False),
    ("width not whole loads", dict(width=4100), False),
    ("width over the norm's rows", dict(width=8200), False),
    ("ffn not whole loads", dict(ffn=11004), False),
    ("int8 cache without scales", dict(cache=("int8", False)), False),
    ("fp32 cache", dict(cache=("float32", False)), False),
])
def test_takes_on_stand_ins(case, kw, want):
    """The kernels take bf16 activations on the card, head dim 128, widths
    of whole 16-byte loads (the norm's at most 8192) and a bf16 cache or an
    int8 one with scales."""
    assert layer_tail.takes(*_stand_in(**kw)) is want, case


def _tiny(dtype=torch.float32, kv_heads=None, seed=0):
    """A two-layer trunk with norms that are not all ones."""
    import dataclasses

    cfg = dataclasses.replace(llama.tiny_config(dtype=dtype), num_kv_heads=kv_heads)
    params = janus._init_language(janus._Init(seed, torch.device("cpu")), cfg, False)
    g = torch.Generator().manual_seed(seed + 1)
    for holder, name in ((params["layers"], "attn_norm"), (params["layers"], "mlp_norm"),
                         (params, "final_norm")):
        w = holder[name]
        holder[name] = (1 + 0.3 * torch.randn(w.shape, generator=g)).to(dtype)
    return cfg, params


def _inputs(cfg, B=3, T=12, seed=2):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, cfg.hidden_size), np.float32))
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, :4] = 0
    return x.to(cfg.dtype), mask, llama.positions_from_mask(mask)


def _count(monkeypatch, take=True):
    """``takes`` forced to ``take`` and a count of the wrappers' calls."""
    calls = dict.fromkeys(("takes",) + TAIL, 0)

    def wrap(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(layer_tail, "takes", wrap("takes", lambda *a: take))
    for name in TAIL:
        monkeypatch.setattr(layer_tail, name, wrap(name, getattr(layer_tail, name)))
    return calls


@pytest.mark.parametrize("case,layout,kv_quant,kv_heads,per_row,want", [
    ("shbd int8", "shbd", "int8", None, False, True),
    ("shbd model dtype", "shbd", False, None, False, True),
    ("bshd", "bshd", "int8", None, False, False),
    ("bhsd", "bhsd", False, None, False, False),
    ("int4 cache", "shbd", "int4", None, False, False),
    ("per-row offsets (SJD)", "bshd", "int8", None, True, False),
    ("GQA", "shbd", "int8", 2, False, False),
])
def test_forward_takes_the_route_only_where_it_holds(monkeypatch, case, layout, kv_quant,
                                                     kv_heads, per_row, want):
    """With ``takes`` forced, the forward still keeps the plain ops on the
    plain reads (``bshd``, ``bhsd``, int4), under per-row offsets and on
    GQA, where it does not even ask; on the ``shbd`` MHA cache a prefill and
    a T = 1 step each launch two norms a layer plus the final one, one rope
    and one SiLU·up a layer."""
    cfg, params = _tiny(kv_heads=kv_heads)
    calls = _count(monkeypatch)
    x, mask, pos = _inputs(cfg)
    B, T = mask.shape
    cache = llama.init_kv_cache(cfg, B, T + 4, quantized=kv_quant, layout=layout)
    kw = dict(cache_positions=torch.zeros(B, dtype=torch.long)) if per_row else {}
    llama.forward(params, cfg, x, mask, pos, kv_cache=cache, self_attn=True, **kw)
    wmask = torch.cat([mask, torch.ones((B, 4), dtype=torch.int32)], 1)
    if per_row:
        kw = dict(cache_positions=torch.full((B,), T, dtype=torch.long))
    llama.forward(params, cfg, x[:, :1], wmask, pos[:, -1:] + 1, kv_cache=cache, **kw)
    L = cfg.num_layers
    assert calls == ({"takes": 2, "add_rms_norm": 2 * (2 * L + 1), "rope_kv_write": 2 * L,
                      "silu_mul": 2 * L} if want else
                     dict.fromkeys(calls, 0)), case


def test_the_training_path_and_the_cpu_take_no_tail(monkeypatch):
    """The no-cache training forward never asks; a cached forward on the
    CPU asks and is refused (``takes`` as it is), so it runs the plain ops."""
    cfg, params = _tiny()
    x, mask, pos = _inputs(cfg)
    calls = _count(monkeypatch)
    llama.forward(params, cfg, x, mask, pos)
    assert calls == dict.fromkeys(calls, 0)
    monkeypatch.undo()
    seen = []
    real = layer_tail.takes
    monkeypatch.setattr(layer_tail, "takes", lambda *a: seen.append(real(*a)) or seen[-1])
    cache = llama.init_kv_cache(cfg, 3, 16, quantized="int8")
    llama.forward(params, cfg, x, mask, pos, kv_cache=cache, self_attn=True)
    assert seen == [False]


# -- the plain forms against the chain ---------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("add", [True, False])
def test_add_rms_norm_plain_is_the_chain(dtype, add):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn((4, 3, 256), generator=g) * 3).to(dtype)
    y = torch.randn((4, 3, 256), generator=g).to(dtype) if add else None
    w = (1 + 0.3 * torch.randn(256, generator=g)).to(dtype)
    got_x, got_h = layer_tail.add_rms_norm(x, y, w, 1e-6)
    want_x = x + y if add else x
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_h, _chain_norm(want_x, w, 1e-6))
    assert torch.equal(layer_tail.rms_norm(x, w, 1e-6), _chain_norm(x, w, 1e-6))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_silu_mul_plain_is_the_chain(dtype):
    g = torch.Generator().manual_seed(4)
    gate, up = (torch.randn((5, 1, 512), generator=g).mul(4).to(dtype) for _ in range(2))
    want = F.silu(gate.float()).to(dtype) * up
    assert torch.equal(layer_tail.silu_mul(gate, up), want)


@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("T,start", [(1, 7), (1, "device"), (6, 0), (6, 9)])
def test_rope_kv_write_plain_is_the_chain(kv, T, start):
    """Rope on q and k, then the forward's cache writer (``_write_kv``) at a
    host or a device position, against the plain form: q, k and every cache
    tensor bit-equal; the fused projection's views as they are."""
    B, H, D, S = 3, 4, 128, 16
    g = torch.Generator().manual_seed(5)
    qkv = (torch.randn((B, T, 3 * H * D), generator=g) * 2).to(torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    pos = torch.arange(T)[None].expand(B, T) + torch.tensor([[0], [3], [5]])
    cfg = llama.tiny_config(hidden_size=H * D, num_heads=H, dtype=torch.bfloat16)
    cos, sin = llama.rope_frequencies(cfg, pos)
    at = torch.tensor([7]) if start == "device" else start

    def cache():
        c = llama.init_kv_cache(llama.tiny_config(hidden_size=H * D, num_heads=H, num_layers=2,
                                                  dtype=torch.bfloat16),
                                B, S, quantized=kv == "int8")
        return c

    want_c, got_c = cache(), cache()
    want_q, want_k = _chain_rope(q, cos, sin), _chain_rope(k, cos, sin)
    llama._write_kv(want_c, 1, at, want_k, v)
    got_q, got_k = layer_tail.rope_kv_write(q, k, v, cos, sin, got_c, 1, at, roped_k=True)
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)
    for name in want_c:
        if isinstance(want_c[name], torch.Tensor):
            assert torch.equal(got_c[name], want_c[name]), name
    assert layer_tail.rope_kv_write(q, k, v, cos, sin, cache(), 0, at)[1] is None


@pytest.mark.parametrize("fn,args,match", [
    ("add_rms_norm", lambda m: (m((2, 64), torch.float32), None, m((64,), torch.float32), 1e-6),
     "bfloat16"),
    ("add_rms_norm", lambda m: (m((2, 60)), None, m((60,)), 1e-6), "multiple of 8"),
    ("add_rms_norm", lambda m: (m((2, 64)), m((2, 32)), m((64,)), 1e-6), "multiple of 8"),
    ("silu_mul", lambda m: (m((2, 64)), m((2, 64), torch.float16)), "bfloat16"),
    ("silu_mul", lambda m: (m((2, 64)), m((2, 32))), "equal shapes"),
])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(fn, args, match):
    """Off the CPU a wrapper checks its inputs before it builds or launches
    anything (tensors on the ``meta`` device stand in for the card's)."""
    def m(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match=match):
        getattr(layer_tail, fn)(*args(m))


# -- the forward on the route against the plain route ------------------------

@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_the_route_forward_equals_the_plain_forward(monkeypatch, kv):
    """A bf16 trunk over an ``shbd`` cache: the prefill, a T = 1 step at a
    host length, one at a device length, and a T > 1 cached step, through
    the route's plain forms (``takes`` forced) and through the plain ops:
    hidden states and every cache tensor bit for bit."""
    cfg, params = _tiny(torch.bfloat16)
    x, mask, pos = _inputs(cfg)
    B, T = mask.shape
    S, T2 = T + 10, 5
    wmask = torch.cat([mask, torch.ones((B, 10), dtype=torch.int32)], 1)
    rng = np.random.default_rng(9)
    steps = [torch.from_numpy(rng.standard_normal((B, n, cfg.hidden_size), np.float32))
             .to(cfg.dtype) for n in (1, 1, T2)]

    def run(take):
        monkeypatch.setattr(layer_tail, "takes", lambda *a: take)
        cache = llama.init_kv_cache(cfg, B, S, quantized=kv == "int8")
        outs = [llama.forward(params, cfg, x, mask, pos, kv_cache=cache, self_attn=True)[0]]
        p = pos[:, -1:]
        outs.append(llama.forward(params, cfg, steps[0], wmask, p + 1, kv_cache=cache)[0])
        dev = {**cache, "length": torch.tensor([cache["length"]], dtype=torch.int32)}
        outs.append(llama.forward(params, cfg, steps[1], wmask, p + 2, kv_cache=dev)[0])
        cache["length"] = int(dev["length"])
        outs.append(llama.forward(params, cfg, steps[2], wmask,
                                  p + 3 + torch.arange(T2)[None], kv_cache=cache)[0])
        return outs, cache

    got, got_c = run(True)
    want, want_c = run(False)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert got_c["length"] == want_c["length"] == T + 2 + T2
    for name in ("k", "v", "k_s", "v_s"):
        if name in want_c:
            assert torch.equal(got_c[name], want_c[name]), name


def test_the_graph_loop_on_the_route_equals_the_plain_eager_loop(monkeypatch):
    """The image engine's loop over a trunk graph's buffers (the device
    length, the fed embeds and positions), run eagerly as the CPU must,
    with the route's plain forms forced, against the plain eager loop:
    forced logits bit for bit."""
    from ospo_tpu_torch.config import Config
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine
    from ospo_tpu_torch.pipeline.model_factory import get_model
    from ospo_tpu_torch.processing import t2i_prompt

    model, _, proc = get_model(Config.from_nested(
        {"model_path": None, "model_preset": "tiny", "device": "cpu"}))
    kw = dict(image_token_num=model.cfg.num_gen_tokens, img_size=model.cfg.gen_image_size,
              patch_size=model.cfg.vq.downsample_factor, kv_quant="int8")
    graph, eager = ImageGenEngine(model, proc, **kw), ImageGenEngine(model, proc, **kw)
    graph._replays_trunk = lambda: True
    prompts = [t2i_prompt(proc, p) for p in ("A red cube on top of a blue sphere", "Two cats")]
    forced = np.random.default_rng(3).integers(0, model.cfg.image_token_size,
                                               (2, eager.image_token_num))
    want = eager.forced_cfg_logits(prompts, forced)
    calls = _count(monkeypatch)
    got = graph.forced_cfg_logits(prompts, forced)
    assert calls["rope_kv_write"] == model.cfg.language.num_layers * eager.image_token_num
    assert np.array_equal(got, want)
