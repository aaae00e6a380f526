"""Port models (``ospo_tpu_torch.models``) against the JAX package on the CPU.

Both packages compute on the same numpy weights (JAX random init, mapped
with ``weights.from_jax_params``), at the JAX package's tiny sizes in fp32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ospo_tpu.models import janus as jjanus
from ospo_tpu.models import llama as jllama
from ospo_tpu.models import vqgan as jvq
from ospo_tpu.ops import quant as jquant
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models import llama as tllama
from ospo_tpu_torch.models import vqgan as tvq
from ospo_tpu_torch.models.weights import from_jax_params
from ospo_tpu_torch.ops import quant as tquant

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_llama(jparams):
    return from_jax_params({"language_model": _np_tree(jparams)})["language_model"]


def _quantized(jparams):
    layers = dict(jparams["layers"])
    for name in jquant.QUANTIZABLE:
        layers[name] = jquant.quantize_matrix(layers[name])
    return {**jparams, "layers": layers}


def _prompt_batch(b=2, t=12, pad=(0, 5)):
    mask = np.ones((b, t), np.int32)
    for i, p in enumerate(pad):
        mask[i, :p] = 0
    return mask


@pytest.mark.parametrize("kv_quant", [False, "int8"])
@pytest.mark.parametrize("int8_weights", [False, True])
def test_llama_prefill_and_decode_step(int8_weights, kv_quant):
    """Prefill hidden states and the written cache, then one cached decode
    step, against ``llama.forward`` with the shbd cache (XLA read path).
    fp32 throughout; hidden states within 1e-4 (summation order through two
    layers).  Left-pad query rows are compared out: the two define a fully
    masked row differently (ops/flash_attention.py), and nothing valid
    reads them."""
    cfg_j = jllama.tiny_config()
    cfg_t = tllama.tiny_config()
    jp = jllama.init_params(cfg_j, jax.random.PRNGKey(0))
    if int8_weights:
        jp = _quantized(jp)
    tp = _port_llama(jp)
    rng = np.random.default_rng(0)
    B, T, S = 2, 12, 20
    x = rng.standard_normal((B, T, cfg_j.hidden_size), np.float32)
    mask = _prompt_batch(B, T)
    pos = np.asarray(jllama.positions_from_mask(jnp.asarray(mask)))

    jc = jllama.init_kv_cache(cfg_j, B, S, quantized=kv_quant, layout="shbd")
    jh, jc = jllama.forward(jp, cfg_j, jnp.asarray(x), jnp.asarray(mask),
                            jnp.asarray(pos), kv_cache=jc, self_attn=True,
                            cache_layout="shbd")
    tc = tllama.init_kv_cache(cfg_t, B, S, quantized=kv_quant)
    th, tc = tllama.forward(tp, cfg_t, torch.from_numpy(x), torch.from_numpy(mask),
                            torch.from_numpy(pos), kv_cache=tc, self_attn=True)
    valid = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid],
                               atol=1e-4, rtol=1e-4)
    assert tc["length"] == int(jc["length"]) == T
    vpos = valid.T                                   # [T, B] cache row order
    for name in ("k", "v"):
        got = tc[name][:, :T].numpy().transpose(0, 1, 3, 2, 4)[:, vpos]
        ref = np.asarray(jc[name])[:, :T].transpose(0, 1, 3, 2, 4)[:, vpos]
        if kv_quant:   # int8 payload: equal but for rare rounding ties
            diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            s_got = tc[name + "_s"][:, :T].numpy().transpose(0, 1, 3, 2)[:, vpos]
            s_ref = np.asarray(jc[name + "_s"])[:, :T].transpose(0, 1, 3, 2)[:, vpos]
            np.testing.assert_allclose(s_got, s_ref, rtol=1e-4)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)

    # one cached decode step over the whole window
    window = np.concatenate([mask, np.ones((B, S - T), np.int32)], axis=1)
    xd = rng.standard_normal((B, 1, cfg_j.hidden_size), np.float32)
    pd = mask.sum(-1, keepdims=True).astype(np.int32)
    jh2, _ = jllama.forward(jp, cfg_j, jnp.asarray(xd), jnp.asarray(window),
                            jnp.asarray(pd), kv_cache=jc, cache_layout="shbd")
    th2, tc = tllama.forward(tp, cfg_t, torch.from_numpy(xd),
                             torch.from_numpy(window), torch.from_numpy(pd),
                             kv_cache=tc)
    assert tc["length"] == T + 1
    np.testing.assert_allclose(th2.numpy(), np.asarray(jh2), atol=1e-4,
                               rtol=1e-4)


def test_llama_forward_without_cache():
    cfg_j, cfg_t = jllama.tiny_config(), tllama.tiny_config()
    jp = jllama.init_params(cfg_j, jax.random.PRNGKey(1))
    tp = _port_llama(jp)
    x = np.random.default_rng(1).standard_normal((2, 9, 64), np.float32)
    mask = _prompt_batch(2, 9, (3, 0))
    pos = np.asarray(jllama.positions_from_mask(jnp.asarray(mask)))
    jh, _ = jllama.forward(jp, cfg_j, jnp.asarray(x), jnp.asarray(mask),
                           jnp.asarray(pos))
    th, _ = tllama.forward(tp, cfg_t, *(torch.from_numpy(a) for a in (x, mask, pos)))
    valid = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid],
                               atol=1e-4, rtol=1e-4)


def test_building_blocks_bf16():
    """rms_norm (cast to bf16 before the weight multiply) and RoPE in bf16
    match bit for bit or within one bf16 ulp; positions_from_mask is
    identical."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64), np.float32)
    w = rng.standard_normal((64,), np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    ref = np.asarray(jllama.rms_norm(jx, jw, 1e-6).astype(jnp.float32))
    got = tllama.rms_norm(tx, tw, 1e-6).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=0)

    mask = _prompt_batch(2, 5, (2, 0))
    jpos = jllama.positions_from_mask(jnp.asarray(mask))
    tpos = tllama.positions_from_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    cfg_j, cfg_t = jllama.tiny_config(), tllama.tiny_config()
    jcos, jsin = jllama.rope_frequencies(cfg_j, jpos)
    tcos, tsin = tllama.rope_frequencies(cfg_t, tpos)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6)
    q = rng.standard_normal((2, 5, 4, 16), np.float32)
    jr = jllama.apply_rope(jnp.asarray(q, jnp.bfloat16), jcos, jsin)
    tr = tllama.apply_rope(torch.from_numpy(q).bfloat16(), tcos, tsin)
    np.testing.assert_allclose(tr.float().numpy(),
                               np.asarray(jr.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def np_janus_params(cfg, seed):
    """The JAX Janus param tree, filled from numpy with the JAX init's
    distributions (convs He-normal, other weights N(0, 0.02), norm scales
    1, biases 0) — without compiling the JAX init."""
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


@functools.lru_cache(maxsize=1)
def _tiny_janus():
    cfg = jjanus.tiny_janus_config()
    params = np_janus_params(cfg, 3)
    return cfg, params, from_jax_params(params)


def test_vq_decode_code_matches_jax():
    """decode_code pixels: float within 1e-4 (fp32 convolutions), uint8
    (the engine's clip((x+1)*127.5) and truncation) off by at most 1."""
    cfg, jp, tp = _tiny_janus()
    ids = np.random.default_rng(4).integers(0, cfg.vq.codebook_size, (2, 64))
    decode = jax.jit(lambda p, i: jvq.decode_code(p, cfg.vq, i))
    ref = np.asarray(decode(jp["gen_vision_model"], jnp.asarray(ids)))
    got = tvq.decode_code(tp["gen_vision_model"], tvq.tiny_vq_config(),
                          torch.from_numpy(ids)).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    u8 = lambda a: np.clip((a + 1.0) * 127.5, 0, 255).astype(np.uint8)  # noqa: E731
    assert np.abs(u8(got).astype(int) - u8(ref).astype(int)).max() <= 1


def test_generation_heads_match_jax():
    """gen_logits (fp32 out) and prepare_gen_img_embeds, fp32 weights."""
    cfg, jp, tp = _tiny_janus()
    tcfg = tjanus.tiny_janus_config()
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 1, cfg.n_embed), np.float32)
    ref = np.asarray(jjanus.gen_logits(jp, jnp.asarray(h)))
    got = tjanus.gen_logits(tp, torch.from_numpy(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    ids = rng.integers(0, cfg.image_token_size, (3, 1))
    ref = np.asarray(jjanus.prepare_gen_img_embeds(jp, cfg, jnp.asarray(ids)))
    got = tjanus.prepare_gen_img_embeds(tp, tcfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_random_init_quantizes_each_matrix():
    """The port's random init: int8 trunk dicts of the right shapes, the
    gen side in the model dtype, no lm_head, seeded reproducibly."""
    cfg = tjanus.tiny_janus_config()
    a = tjanus.JanusModel.init(cfg, seed=0, quantize="int8", device="cpu")
    b = tjanus.JanusModel.init(cfg, seed=0, quantize="int8", device="cpu")
    layers = a.params["language_model"]["layers"]
    assert layers["w_gate"]["q"].shape == (2, 128, 64)
    assert layers["w_gate"]["q"].dtype == torch.int8
    assert layers["w_gate"]["s"].shape == (2, 128)
    assert "lm_head" not in a.params["language_model"]
    torch.testing.assert_close(layers["wq"]["q"],
                               b.params["language_model"]["layers"]["wq"]["q"])
    w = layers["wo"]
    deq = w["q"].float() * w["s"][..., None]
    assert float(deq.std()) == pytest.approx(0.02, rel=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tjanus.JanusModel.init(cfg, quantize="int4", device="cpu")


def test_load_janus_matches_jax_loader(tmp_path):
    """A synthetic HF-keyed checkpoint loads to the same generation-side
    weights and config in both packages."""
    from ospo_tpu.models import weights as jweights
    from ospo_tpu.models.synthetic import write_synthetic_checkpoint
    from ospo_tpu_torch.models import weights as tweights

    cfg = jjanus.tiny_janus_config()
    path = write_synthetic_checkpoint(str(tmp_path / "ckpt"), cfg, seed=0)
    jmodel = jweights.load_janus(path, use_cache=False)
    tmodel = tweights.load_janus(path, device="cpu")
    jc, tc = jmodel.cfg, tmodel.cfg
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
              "num_heads", "kv_heads", "rope_theta", "rms_norm_eps"):
        assert getattr(tc.language, f) == getattr(jc.language, f), f
    assert (tc.vq.ch_mult, tc.vq.codebook_size, tc.vq.z_channels) == \
        (jc.vq.ch_mult, jc.vq.codebook_size, jc.vq.z_channels)
    assert (tc.image_token_size, tc.gen_image_size, tc.gen_embed_dim) == \
        (jc.image_token_size, jc.gen_image_size, jc.gen_embed_dim)
    ref = from_jax_params(_np_tree(jmodel.params))
    ref["language_model"].pop("lm_head")

    def compare(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                compare(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                compare(x, y, f"{path}/{i}")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            torch.testing.assert_close(a, b, atol=0, rtol=0, msg=path)

    compare(tmodel.params, ref)


def test_quantized_trunk_from_loader_is_int8(tmp_path):
    from ospo_tpu.models.synthetic import write_synthetic_checkpoint
    from ospo_tpu_torch.models import weights as tweights

    path = write_synthetic_checkpoint(str(tmp_path / "ckpt"),
                                      jjanus.tiny_janus_config(), seed=1)
    m = tweights.load_janus(path, device="cpu", quantize=True)
    w = m.params["language_model"]["layers"]["w_up"]
    ref = tquant.quantize_matrix(
        tweights.load_janus(path, device="cpu").params["language_model"]
        ["layers"]["w_up"])
    torch.testing.assert_close(w["q"], ref["q"], atol=0, rtol=0)
    torch.testing.assert_close(w["s"], ref["s"], atol=0, rtol=0)
