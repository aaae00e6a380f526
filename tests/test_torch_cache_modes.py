"""The port's opt-in cache modes against the JAX package on the CPU: the
``bshd`` / ``bhsd`` / ``shbd`` layouts, int8 and int4 KV, per-row cache
offsets, the plain cache read, the engine's layouts and speculative Jacobi
decoding (SJD), and the combinations the JAX package refuses.

Both packages compute on the same numpy weights at tiny sizes in fp32.
Quantized cache payloads are equal but for rounding ties of fp32 inputs:
at most one step, on under 0.1% of the values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ospo_tpu.engine.image_engine import ImageGenEngine as JEngine
from ospo_tpu.image_processing import ImageProcessor
from ospo_tpu.models import janus as jjanus
from ospo_tpu.models import llama as jllama
from ospo_tpu.ops.attention import unpack_int4 as j_unpack_int4
from ospo_tpu.ops.attention import xla_attention as j_xla_attention
from ospo_tpu.ops import quant as jquant
from ospo_tpu.processing import Processor as JProcessor
from ospo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from ospo_tpu_torch.engine.image_engine import ImageGenEngine as TEngine
from ospo_tpu_torch.engine.scoring import ScoringEngine
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models import llama as tllama
from ospo_tpu_torch.models.weights import from_jax_params
from ospo_tpu_torch.ops import attention as tattn
from ospo_tpu_torch.ops import quant as tquant
from ospo_tpu_torch.processing import Processor as TProcessor
from ospo_tpu_torch.processing import t2i_prompt
from ospo_tpu_torch.tokenizer import ByteTokenizer as TByteTokenizer

torch.set_num_threads(2)
# torch's CPU exp (MKL's vector math) sets itself up on its first call; in
# some processes the worker thread's share of that first parallel call came
# out ~1e-4 off, and every later call was exact: make that call here, once on
# this thread and once spread over both threads
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))

LAYOUTS = ("bshd", "bhsd", "shbd")
# a layout's cache [L, ...] → [L, B, S, H, Dh], its scales → [L, B, S, H]
TO_BSHD = {"bshd": (0, 1, 2, 3, 4), "bhsd": (0, 1, 3, 2, 4),
           "shbd": (0, 3, 1, 2, 4)}
SCALES_TO_BSH = {"bshd": (0, 1, 3, 2), "bhsd": (0, 1, 3, 2),
                 "shbd": (0, 3, 1, 2)}
# one layer's window [B, S, H, Dh] → a layout's order
FROM_BSHD = {"bshd": (0, 1, 2, 3), "bhsd": (0, 2, 1, 3), "shbd": (1, 2, 0, 3)}


def _ties_only(got, ref):
    """Integer payloads equal but for rounding ties: ≤ 1 step, < 0.1%."""
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max(initial=0) <= 1 and (diff > 0).mean() < 1e-3


def _nibbles(packed):
    lo, hi = tattn.unpack_int4(torch.from_numpy(np.asarray(packed)))
    return np.concatenate([lo.numpy(), hi.numpy()], axis=-2)


def _compare_cache(tc, jc, layout, int4, valid):
    """The written rows ``valid`` [B, S] of both caches: model-dtype values
    within 1e-4, quantized payloads by the tie rule, scales within 1e-6."""
    for name in ("k", "v"):
        got = tc[name].numpy().transpose(TO_BSHD[layout])[:, valid]
        ref = np.asarray(jc[name]).transpose(TO_BSHD[layout])[:, valid]
        if "k_s" not in tc:
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
            continue
        if int4:
            got, ref = _nibbles(got), _nibbles(ref)
        _ties_only(got, ref)
        sg = tc[name + "_s"].numpy().transpose(SCALES_TO_BSH[layout])[:, valid]
        sr = np.asarray(jc[name + "_s"]).transpose(SCALES_TO_BSH[layout])[:, valid]
        np.testing.assert_allclose(sg, sr, rtol=1e-6)


def _port_llama(jparams):
    return from_jax_params({"language_model": jax.tree.map(
        np.asarray, jparams)})["language_model"]


@pytest.fixture(scope="module")
def tiny_llama():
    cfg_j = jllama.tiny_config()
    jp = jllama.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, tllama.tiny_config(), jp, _port_llama(jp)


# ---------------------------------------------------------------------------
# the cache and its quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, "int8", "int4"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_init_kv_cache_shapes(layout, quantized):
    cfg_j, cfg_t = jllama.tiny_config(), tllama.tiny_config()
    jc = jllama.init_kv_cache(cfg_j, 3, 20, quantized=quantized, layout=layout)
    tc = tllama.init_kv_cache(cfg_t, 3, 20, quantized=quantized, layout=layout)
    assert tc["length"] == 0 and tc["layout"] == layout
    assert set(tc) - {"layout"} == set(jc)
    for name in set(jc) - {"length"}:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype), name


def test_quantize_rows_int4_and_unpack_match_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 4, 16)).astype(np.float32)
    jq, js = jllama._quantize_rows_int4(jnp.asarray(x))
    tq, ts = tllama._quantize_rows_int4(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == jq.shape == (3, 5, 2, 16)
    _ties_only(_nibbles(tq.numpy()), _nibbles(np.asarray(jq)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    every_byte = np.arange(-128, 128, dtype=np.int8)
    jlo, jhi = j_unpack_int4(jnp.asarray(every_byte))
    tlo, thi = tattn.unpack_int4(torch.from_numpy(every_byte))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


# ---------------------------------------------------------------------------
# the plain read over every layout and payload
# ---------------------------------------------------------------------------


def _window(layout, payload, rng, B=3, S=11, H=4, Dh=16):
    """A cache window in ``layout`` for both packages (the same numpy
    payload): plain fp32, int8 ``{"q", "s"}`` or int4 ``{"q4", "s"}``, scales
    [B, H, S]."""
    k = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    out = []
    for x in (k, v):
        if payload == "plain":
            a = x.transpose(FROM_BSHD[layout])
            out.append((jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))))
            continue
        fn = jllama._quantize_rows_int4 if payload == "int4" else jllama._quantize_rows
        q, s = (np.asarray(t) for t in fn(jnp.asarray(x)))
        q = q.transpose(FROM_BSHD[layout])
        s = s.transpose(0, 2, 1)                       # [B, S, H] → [B, H, S]
        key = "q4" if payload == "int4" else "q"
        out.append(({key: jnp.asarray(q), "s": jnp.asarray(s)},
                    {key: torch.from_numpy(np.ascontiguousarray(q)),
                     "s": torch.from_numpy(np.ascontiguousarray(s))}))
    return out


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("payload", ["plain", "int8", "int4"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_xla_attention_layouts_payloads_offsets(layout, payload, per_row):
    """Within 1e-5 of the JAX ``xla_attention`` for a shared and a per-row
    query offset; the int8 / bshd case also with a batch-shared prefix."""
    rng = np.random.default_rng(1)
    B, T, S, H, Dh = 3, 2, 11, 4, 16
    (jk, tk), (jv, tv) = _window(layout, payload, rng, B, S, H, Dh)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, :3] = 0
    mask[2, 5] = 0
    off = np.array([4, 7, 9], np.int32) if per_row else 6
    kw_j, kw_t = {}, {}
    if payload == "int8" and not per_row:
        pk = rng.standard_normal((5, H, Dh)).astype(np.float32)
        pv = rng.standard_normal((5, H, Dh)).astype(np.float32)
        pm = np.array([0, 1, 1, 1, 1], np.int32)
        kw_j = dict(prefix_k=jnp.asarray(pk), prefix_v=jnp.asarray(pv),
                    prefix_mask=jnp.asarray(pm))
        kw_t = dict(prefix_k=torch.from_numpy(pk), prefix_v=torch.from_numpy(pv),
                    prefix_mask=torch.from_numpy(pm))
    ref = j_xla_attention(jnp.asarray(q), jk, jv, jnp.asarray(mask),
                              jnp.asarray(off) if per_row else off, True,
                              kv_layout=layout, **kw_j)
    got = tattn.xla_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(mask),
                              torch.from_numpy(off) if per_row else off, True,
                              kv_layout=layout, **kw_t)
    assert got.shape == (B, T, H, Dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# llama.forward: prefill, then cached steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, "int8"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_per_row_offsets_matches_jax(tiny_llama, layout, kv_quant):
    """Prefill, then 3 cached steps: on ``bshd`` / ``bhsd`` two tokens a
    step at per-row ``cache_positions`` that advance unevenly and rewrite
    rejected rows, as SJD does; on ``shbd`` (no per-row offsets) one token
    a step at the shared offset through a truncated window.  Hidden states
    within 1e-4 of JAX's, cache payloads equal (tie rule)."""
    cfg_j, cfg_t, jp, tp = tiny_llama
    rng = np.random.default_rng(2)
    B, T, S, D = 2, 8, 20, cfg_j.hidden_size
    mask = np.ones((B, T), np.int32)
    mask[1, :3] = 0
    pos = np.asarray(jllama.positions_from_mask(jnp.asarray(mask)))
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jc = jllama.init_kv_cache(cfg_j, B, S, quantized=kv_quant, layout=layout)
    tc = tllama.init_kv_cache(cfg_t, B, S, quantized=kv_quant, layout=layout)
    jh, jc = jllama.forward(jp, cfg_j, jnp.asarray(x), jnp.asarray(mask),
                            jnp.asarray(pos), kv_cache=jc, self_attn=True,
                            cache_layout=layout)
    th, tc = tllama.forward(tp, cfg_t, torch.from_numpy(x), torch.from_numpy(mask),
                            torch.from_numpy(pos), kv_cache=tc, self_attn=True)
    valid = np.zeros((B, S), bool)
    valid[:, :T] = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[mask.astype(bool)],
                               np.asarray(jh)[mask.astype(bool)], atol=1e-4,
                               rtol=1e-4)
    plen = mask.sum(-1)
    per_row = layout != "shbd"
    steps = [(0, 0), (2, 1), (3, 3)] if per_row else [(0, 0), (1, 1), (2, 2)]
    W = 2 if per_row else 1
    for adv in steps:
        adv = np.asarray(adv, np.int32)
        rows = T + adv                                   # first row written
        xs = rng.standard_normal((B, W, D)).astype(np.float32)
        ps = (plen + adv)[:, None] + np.arange(W)[None, :]
        win = np.zeros((B, S), np.int32)
        win[:, :T] = mask
        for b in range(B):
            win[b, T:rows[b] + W] = 1
        kw_j = dict(cache_positions=jnp.asarray(rows)) if per_row else \
            dict(attn_window=16)
        kw_t = dict(cache_positions=torch.from_numpy(rows)) if per_row else \
            dict(attn_window=16)
        jwin = win if per_row else win[:, :16]
        jh, jc = jllama.forward(jp, cfg_j, jnp.asarray(xs), jnp.asarray(jwin),
                                jnp.asarray(ps), kv_cache=jc,
                                cache_layout=layout, **kw_j)
        th, tc = tllama.forward(tp, cfg_t, torch.from_numpy(xs),
                                torch.from_numpy(win), torch.from_numpy(ps),
                                kv_cache=tc, **kw_t)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                                   rtol=1e-4, err_msg=str(adv))
        for b in range(B):
            valid[b, T:rows[b] + W] = True
    _compare_cache(tc, jc, layout, False, valid)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_int4_cache_forward_matches_jax(tiny_llama, layout):
    """An int4 cache: prefill, then 3 shared-offset T = 1 steps read through
    the plain form (window 12): hidden states within 1e-4 of JAX's, the
    packed payload equal (tie rule)."""
    cfg_j, cfg_t, jp, tp = tiny_llama
    rng = np.random.default_rng(3)
    B, T, S, D = 2, 8, 16, cfg_j.hidden_size
    mask = np.ones((B, T), np.int32)
    mask[0, :2] = 0
    pos = np.asarray(jllama.positions_from_mask(jnp.asarray(mask)))
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jc = jllama.init_kv_cache(cfg_j, B, S, quantized="int4", layout=layout)
    tc = tllama.init_kv_cache(cfg_t, B, S, quantized="int4", layout=layout)
    _, jc = jllama.forward(jp, cfg_j, jnp.asarray(x), jnp.asarray(mask),
                           jnp.asarray(pos), kv_cache=jc, self_attn=True,
                           cache_layout=layout)
    _, tc = tllama.forward(tp, cfg_t, torch.from_numpy(x), torch.from_numpy(mask),
                           torch.from_numpy(pos), kv_cache=tc, self_attn=True)
    win = np.concatenate([mask, np.ones((B, S - T), np.int32)], axis=1)
    for i in range(3):
        xs = rng.standard_normal((B, 1, D)).astype(np.float32)
        ps = (mask.sum(-1) + i)[:, None].astype(np.int32)
        jh, jc = jllama.forward(jp, cfg_j, jnp.asarray(xs),
                                jnp.asarray(win[:, :12]), jnp.asarray(ps),
                                kv_cache=jc, attn_window=12, cache_layout=layout)
        th, tc = tllama.forward(tp, cfg_t, torch.from_numpy(xs),
                                torch.from_numpy(win), torch.from_numpy(ps),
                                kv_cache=tc, attn_window=12)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                                   rtol=1e-4)
    valid = np.zeros((B, S), bool)
    valid[:, :T] = mask.astype(bool)
    valid[:, T:T + 3] = True
    _compare_cache(tc, jc, layout, True, valid)


# ---------------------------------------------------------------------------
# the image engine: layouts, int4 KV and SJD
# ---------------------------------------------------------------------------


def _np_janus_params(cfg, seed):
    """The JAX Janus param tree from numpy with the JAX init's
    distributions (convs He-normal, other weights N(0, 0.02), norm scales
    1, biases 0), without compiling the JAX init."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name[0] == "b" or name.endswith("bias"):
            return np.zeros(leaf.shape, np.float32)
        if "norm" in name or name == "scale":
            return np.ones(leaf.shape, np.float32)
        std = (2.0 / np.prod(leaf.shape[:3])) ** 0.5 if len(leaf.shape) == 4 else 0.02
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jjanus.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def janus_pair():
    """(JAX model, port model, JAX processor, port processor) on the same
    weights, int8 trunk."""
    cfg = jjanus.tiny_janus_config()
    params = _np_janus_params(cfg, 0)
    lm = dict(params["language_model"])
    lm["layers"] = {n: (jquant.quantize_matrix(w) if n in jquant.QUANTIZABLE
                        else w) for n, w in lm["layers"].items()}
    jmodel = jjanus.JanusModel(cfg, {**params, "language_model": lm})
    tparams = from_jax_params(params)
    layers = tparams["language_model"]["layers"]
    for n in tquant.QUANTIZABLE:
        layers[n] = tquant.quantize_matrix(layers[n])
    tmodel = tjanus.JanusModel(tjanus.tiny_janus_config(), tparams,
                               torch.device("cpu"))
    jproc = JProcessor(JByteTokenizer(512), ImageProcessor(image_size=16),
                       num_image_tokens=4)
    return jmodel, tmodel, jproc, TProcessor(TByteTokenizer(512))


PROMPTS = ["A red cube on top of a blue sphere", "Two cats"]


@pytest.mark.parametrize("layout,kv_quant,n_img", [
    ("bshd", "int8", 130), ("bhsd", "int4", 64), ("bshd", "int4", 64),
    ("bhsd", False, 64)])
def test_forced_cfg_logits_layouts_match_jax(janus_pair, layout, kv_quant, n_img):
    """The teacher-forced CFG probe through the engines' serving loops on
    the plain read: within 2e-4 of JAX's (130 image tokens make two
    segments with growing windows)."""
    jmodel, tmodel, jproc, tproc = janus_pair
    forced = np.random.default_rng(4).integers(0, 64, (2, n_img))
    kw = dict(image_token_num=n_img, img_size=16, patch_size=2,
              kv_quant=kv_quant, kv_layout=layout, decode_segments=4)
    jeng, teng = JEngine(jmodel, jproc, **kw), TEngine(tmodel, tproc, **kw)
    prompts = [t2i_prompt(tproc, p) for p in PROMPTS]
    ref = jeng.forced_cfg_logits(prompts, forced)
    got = teng.forced_cfg_logits(prompts, forced)
    assert got.shape == ref.shape == (2, n_img, 64)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)


def _engines(janus_pair, n_img=24, **kw):
    jmodel, tmodel, jproc, tproc = janus_pair
    args = dict(image_token_num=n_img, img_size=16, patch_size=4,
                kv_layout="bshd", **kw)
    return JEngine(jmodel, jproc, **args), TEngine(tmodel, tproc, **args)


def test_sjd_near_greedy_matches_sequential_and_jax(janus_pair):
    """At temperature 1e-4 every draft is the argmax and is accepted: SJD's
    ids equal the port's sequential ids and the JAX SJD ids, in fewer
    model calls than tokens."""
    tproc = janus_pair[3]
    prompts = [t2i_prompt(tproc, "A black umbrella"),
               t2i_prompt(tproc, "A red moon")]
    _, seq = _engines(janus_pair, temperature=1e-4)
    jsjd, sjd = _engines(janus_pair, temperature=1e-4, speculative=4)
    ref = seq.generate_tokens(prompts, seed=0)
    out = sjd.generate_tokens(prompts, seed=0)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jsjd.generate_tokens(prompts, seed=0))
    assert sjd.last_sjd_iters < 24


def test_sjd_sampling_terminates_fills_and_repeats(janus_pair):
    tproc = janus_pair[3]
    _, sjd = _engines(janus_pair, temperature=1.0, speculative=4)
    prompts = [t2i_prompt(tproc, "A cat"), t2i_prompt(tproc, "A dog")]
    out = sjd.generate_tokens(prompts, seed=1)
    assert out.shape == (2, 24) and 0 <= int(out.min()) and int(out.max()) < 64
    assert 1 <= sjd.last_sjd_iters <= 24      # never worse than sequential
    np.testing.assert_array_equal(sjd.generate_tokens(prompts, seed=7),
                                  sjd.generate_tokens(prompts, seed=7))
    _, sjd16 = _engines(janus_pair, n_img=16, speculative=4)  # 4 x 4 latents
    imgs = sjd16.generate_images(prompts[:1], seed=3)
    assert imgs.shape == (1, 8, 8, 3) and imgs.dtype == np.uint8


def test_sjd_window_row_and_rope_convention(janus_pair):
    """One SJD verify window through the port's forward (rows
    ``t_prompt + n_gen - 1``, rotary positions ``prompt_len + n_gen - 1``)
    gives the first slot the distribution of the sequential teacher-forced
    path (the counterpart of ``tests/test_sjd.py:64-123``)."""
    _, eng = _engines(janus_pair)
    tmodel, tproc = janus_pair[1], janus_pair[3]
    params, c = tmodel.params, tmodel.cfg
    prompts = [t2i_prompt(tproc, "A cat")]
    forced = np.zeros((1, 24), np.int64)
    forced[0, 0] = 5
    seq_p1 = torch.softmax(torch.from_numpy(
        eng.forced_cfg_logits(prompts, forced)[0, 1]), -1).numpy()

    tokens, mask = (torch.from_numpy(a).long() for a in eng.build_cfg_batch(prompts))
    two_b, t_prompt = tokens.shape
    W, n_img = 4, 24
    s_max = t_prompt + n_img + W
    kv = tllama.init_kv_cache(c.language, two_b, s_max, layout="bshd")
    _, kv = tjanus.language_forward(
        params, c, tjanus.embed_text(params, tokens), mask,
        tllama.positions_from_mask(mask), kv_cache=kv, self_attn=True)
    n_gen = torch.ones(1, dtype=torch.long)
    row2b = torch.cat([t_prompt + n_gen - 1] * 2)
    inputs = torch.tensor([[5, 0, 0, 0]] * 2)
    pos = (mask.sum(-1) + torch.cat([n_gen, n_gen]) - 1)[:, None] + torch.arange(W)
    s_idx = torch.arange(s_max)[None]
    base = torch.cat([mask, torch.zeros((two_b, s_max - t_prompt), dtype=mask.dtype)], -1)
    m = base | ((s_idx >= t_prompt) & (s_idx < (row2b + W)[:, None])).long()
    hid, _ = tjanus.language_forward(
        params, c, tjanus.prepare_gen_img_embeds(params, c, inputs), m, pos,
        kv_cache=kv, cache_positions=row2b)
    logits = tjanus.gen_logits(params, hid)
    fused = logits[1:] + 5.0 * (logits[:1] - logits[1:])
    p_body = torch.softmax(fused[0, 0].float(), -1).numpy()
    np.testing.assert_allclose(p_body, seq_p1, atol=1e-6)


def test_sjd_first_token_distribution_matches_sequential(janus_pair):
    """Spot-check of distribution preservation: over 40 seeds the second
    image token of SJD and of the sequential engine share support, and SJD
    really samples."""
    tproc = janus_pair[3]
    prompts = [t2i_prompt(tproc, "A cat")]
    _, seq = _engines(janus_pair, n_img=4)
    _, sjd = _engines(janus_pair, n_img=4, speculative=4)
    seq_first = [int(seq.generate_tokens(prompts, seed=s)[0, 1]) for s in range(40)]
    sjd_first = [int(sjd.generate_tokens(prompts, seed=s)[0, 1]) for s in range(40)]
    assert len(set(seq_first) & set(sjd_first)) >= 1
    assert len(set(sjd_first)) > 1


# ---------------------------------------------------------------------------
# what the JAX package refuses
# ---------------------------------------------------------------------------


def test_refused_combinations_raise_value_error(tiny_llama, janus_pair):
    """The JAX asserts as ValueErrors: int4 KV with GQA and with per-row
    offsets, per-row offsets on the batch-minor cache, ``prefix_kv`` with
    per-row offsets (``llama.py:444-473``); SJD on ``shbd`` and with int4
    KV (``image_engine.py:96-111``); an int4 scoring cache
    (``scoring.py:74``)."""
    _, cfg_t, _, tp = tiny_llama
    x = torch.zeros((1, 2, cfg_t.hidden_size))
    m2 = torch.ones((1, 2), dtype=torch.int32)
    m8 = torch.ones((1, 8), dtype=torch.int32)
    gqa = dataclasses.replace(cfg_t, num_kv_heads=2)
    with pytest.raises(ValueError, match="MHA only"):
        tllama.forward(tp, gqa, x, m2, m2,
                       kv_cache=tllama.init_kv_cache(gqa, 1, 8, quantized="int4"),
                       self_attn=True)
    rows = torch.tensor([2])
    with pytest.raises(ValueError, match="int4 KV does not support"):
        tllama.forward(tp, cfg_t, x, m8, m2, cache_positions=rows,
                       kv_cache=tllama.init_kv_cache(cfg_t, 1, 8, "int4", "bshd"))
    with pytest.raises(ValueError, match="batch-minor"):
        tllama.forward(tp, cfg_t, x, m8, m2, cache_positions=rows,
                       kv_cache=tllama.init_kv_cache(cfg_t, 1, 8))
    pre = {"k": torch.zeros((2, 4, 4, 16)), "v": torch.zeros((2, 4, 4, 16)),
           "mask": torch.ones(4, dtype=torch.int32)}
    with pytest.raises(ValueError, match="prefix_kv"):
        tllama.forward(tp, cfg_t, x, m8, m2, cache_positions=rows, prefix_kv=pre,
                       kv_cache=tllama.init_kv_cache(cfg_t, 1, 8, layout="bhsd"))
    tmodel, tproc = janus_pair[1], janus_pair[3]
    with pytest.raises(ValueError, match="per-row offsets"):
        TEngine(tmodel, tproc, kv_layout="shbd", speculative=2)
    with pytest.raises(ValueError, match="int4 KV does not support"):
        TEngine(tmodel, tproc, kv_layout="bhsd", speculative=2, kv_quant="int4")
    with pytest.raises(ValueError, match="int4 KV is a decode-engine option"):
        ScoringEngine(tmodel, tproc, kv_quant="int4")
