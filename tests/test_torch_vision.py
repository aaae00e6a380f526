"""The port's understanding side against the JAX package on the CPU: the
SigLIP tower and its attention pool, ``encode_images`` and the image-row
splice, the bicubic resize against Pillow, the processor's ids, masks and
pixels, the understanding keys of ``load_janus`` with the key-coverage
audit, and the two attention repairs (the dispatcher's head-dim rule; the
cached multi-token step against ``xla_attention`` on the ``shbd`` cache).

Both packages compute on the same numpy weights in fp32 unless a test says
otherwise; each tolerance is stated where it is checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ospo_tpu.image_processing import ImageProcessor as JImageProcessor
from ospo_tpu.models import janus as jjanus
from ospo_tpu.models import vit as jvit
from ospo_tpu.ops.attention import xla_attention as jxla_attention
from ospo_tpu.processing import Processor as JProcessor
from ospo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from ospo_tpu_torch.image_processing import ImageProcessor, pil_bicubic_resize
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models import llama as tllama
from ospo_tpu_torch.models import vit as tvit
from ospo_tpu_torch.models.weights import from_jax_params
from ospo_tpu_torch.ops import attention as tattn
from ospo_tpu_torch.processing import Processor
from ospo_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
# the first parallel torch.exp of a process can come out ~1e-4 off in the
# worker thread's share (MKL VML set-up); make that call here
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))


def _fill_tree(shapes, seed):
    """A JAX param tree of ``shapes`` filled from numpy: biases 0, norm
    scales 1, other leaves N(0, 0.02) (a conv kernel He-scaled)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name[:1] == "b" or name.endswith("bias"):
            return np.zeros(leaf.shape, np.float32)
        if "norm" in name or name == "scale":
            return np.ones(leaf.shape, np.float32)
        std = (2.0 / np.prod(leaf.shape[:3])) ** 0.5 if len(leaf.shape) == 4 else 0.02
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _vit_params(jcfg, seed, pool=False):
    init = jvit.init_attn_pool if pool else jvit.init_params
    tree = _fill_tree(jax.eval_shape(lambda k: init(jcfg, k),
                                     jax.random.PRNGKey(0)), seed)
    if not pool:   # non-trivial norms and biases, so a wrong affine shows
        rng = np.random.default_rng(seed + 1)
        for name in ("norm1_scale", "norm2_scale", "bqkv", "b1"):
            leaf = tree["blocks"][name]
            tree["blocks"][name] = (leaf + 0.1 * rng.standard_normal(leaf.shape)
                                    ).astype(np.float32)
    return tree


def _torch_vit(tree):
    return from_jax_params({"vision_model": tree})["vision_model"]


def _tcfg(jcfg):
    return tvit.ViTConfig(**{f: getattr(jcfg, f) for f in (
        "image_size", "patch_size", "width", "layers", "heads", "mlp_ratio",
        "select_layer", "layer_norm_eps")}, dtype=torch.float32)


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["tiny", "siglip_l_2_layers"])
def test_vit_forward_matches_jax(size):
    """Post-norm patch features: the tiny tower (32 px, width 32, 2 heads),
    and SigLIP-L's widths (384 px, patch 16 → 576 patches, width 1024, 16
    heads of 64, MLP 4096) cut to 2 layers.  Tolerance 1e-4 abs + 1e-4 rel
    (fp32, unit-scale layer-normed outputs)."""
    if size == "tiny":
        jcfg = jvit.tiny_vit_config()
    else:
        jcfg = jvit.ViTConfig(layers=2, dtype=jnp.float32)
    tree = _vit_params(jcfg, 0)
    px = np.random.default_rng(1).standard_normal(
        (2, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jvit.forward(p, jcfg, x))(tree, px))
    out = tvit.forward(_torch_vit(tree), _tcfg(jcfg), torch.as_tensor(px))
    assert out.shape == (2, jcfg.num_patches, jcfg.width)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_vit_select_layer_depth():
    """``select_layer`` truncates the depth as the JAX config does."""
    for layers, sel in ((24, -1), (24, -2), (24, 0), (24, 5), (24, 30)):
        j = jvit.ViTConfig(layers=layers, select_layer=sel)
        t = tvit.ViTConfig(layers=layers, select_layer=sel)
        assert t.depth == j.depth and t.num_patches == j.num_patches \
            and t.mlp_hidden == j.mlp_hidden
    assert tvit.SIGLIP_SO400M_384.mlp_hidden == jvit.SIGLIP_SO400M_384.mlp_hidden


def test_attention_pool_matches_jax():
    """The latent-query pool head [B, N, D] → [B, D]; tolerance 1e-5."""
    jcfg = jvit.tiny_vit_config(width=64, heads=4)
    tree = _vit_params(jcfg, 3, pool=True)
    tokens = np.random.default_rng(4).standard_normal((3, 4, 64)).astype(np.float32)
    ref = np.asarray(jvit.attention_pool(tree, jcfg, tokens))
    out = tvit.attention_pool(_torch_vit(tree), _tcfg(jcfg), torch.as_tensor(tokens))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the Janus understanding path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    cfg = jjanus.tiny_janus_config()
    params = _fill_tree(jax.eval_shape(lambda k: jjanus.init_params(cfg, k),
                                       jax.random.PRNGKey(0)), 5)
    return cfg, params, tjanus.tiny_janus_config(), from_jax_params(params)


def test_tiny_config_equals_jax(tiny_pair):
    jc, _, tc, _ = tiny_pair
    for f in ("image_size", "patch_size", "width", "layers", "heads",
              "mlp_ratio", "select_layer", "layer_norm_eps"):
        assert getattr(tc.vision, f) == getattr(jc.vision, f), f
    assert tc.num_image_tokens == jc.num_image_tokens == 4
    assert tc.aligner_depth == jc.aligner_depth
    assert tc.image_size == jc.vision.image_size
    assert tjanus.JANUS_PRO_7B.num_image_tokens == 576


def test_encode_images_matches_jax(tiny_pair):
    """ViT → aligner; tolerance 1e-5 (fp32)."""
    jc, params, tc, tparams = tiny_pair
    px = np.random.default_rng(6).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jjanus.encode_images(params, jc, px))
    out = tjanus.encode_images(tparams, tc, torch.as_tensor(px))
    assert out.shape == (3, 4, 64)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_prepare_inputs_embeds_is_exact(tiny_pair):
    """The image-row splice on the same precomputed embeddings, bit for bit:
    a row with one image, one with two (the second partly masked), a row
    with no image (text only) and a row with more image slots than valid
    embeddings (the extra slots take zeros in both)."""
    jc, params, tc, tparams = tiny_pair
    rng = np.random.default_rng(7)
    B, T, n, t2 = 4, 20, 2, 4
    ids = rng.integers(0, 256, (B, T)).astype(np.int32)
    ids[0, :3] = -1                                    # pad ids clamp to 0
    seq = np.zeros((B, T), bool)
    seq[0, 5:9] = True
    seq[1, 2:6] = True
    seq[1, 10:12] = True
    seq[3, 1:8] = True
    emb = np.zeros((B, n, t2), bool)
    emb[0, 0] = True
    emb[1, 0] = True
    emb[1, 1, :2] = True
    emb[3, 0] = True
    embeds = rng.standard_normal((B * n, t2, 64)).astype(np.float32)
    ref = np.asarray(jjanus.prepare_inputs_embeds(
        params, jc, ids, None, seq, emb, img_embeds=embeds))
    out = tjanus.prepare_inputs_embeds(
        tparams, tc, torch.as_tensor(ids).long(), None, torch.as_tensor(seq),
        torch.as_tensor(emb), img_embeds=torch.as_tensor(embeds))
    np.testing.assert_array_equal(out.numpy(), ref)
    # and through the encoder from pixels: the same splice of each one's own
    # encode (1e-5, the encoder's tolerance)
    px = rng.standard_normal((B, n, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jjanus.prepare_inputs_embeds(params, jc, ids, px, seq, emb))
    out = tjanus.prepare_inputs_embeds(
        tparams, tc, torch.as_tensor(ids).long(), torch.as_tensor(px),
        torch.as_tensor(seq), torch.as_tensor(emb))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_understanding_init_leaves_other_weights_of_a_seed():
    """The tower and the aligner come from a generator of their own: the
    step-3, step-5 and text weights of a seed are the same with and without
    them (and without the whole vision side), and drop flags leave them
    out."""
    cfg = tjanus.tiny_janus_config()
    full = tjanus.JanusModel.init(cfg, seed=3, device="cpu")
    bare = tjanus.JanusModel.init(cfg, seed=3, device="cpu", understanding=False)
    text = tjanus.JanusModel.init(cfg, seed=3, device="cpu", vision=False)
    assert {"vision_model", "aligner"} <= set(full.params)
    assert not {"vision_model", "aligner"} & set(bare.params)
    assert set(text.params) == {"language_model"}

    def same(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}/{i}")
        else:
            assert torch.equal(a, b), path

    same({k: v for k, v in full.params.items()
          if k not in ("vision_model", "aligner")}, bare.params)
    same(full.params["language_model"], text.params["language_model"])
    blocks = full.params["vision_model"]["blocks"]
    assert blocks["wqkv"].shape == (2, 96, 32)
    assert full.params["vision_model"]["patch_embed"]["w"].shape == (32, 3, 16, 16)
    assert [lp["w"].shape for lp in full.params["aligner"]["layers"]] == \
        [(64, 32), (64, 64)]


# ---------------------------------------------------------------------------
# image processing and the processor
# ---------------------------------------------------------------------------

RESIZES = {
    "landscape_down": ((120, 200), (230, 138)),
    "portrait_down": ((300, 170), (100, 176)),
    "upscale": ((20, 30), (384, 256)),
    "upscale_portrait": ((37, 11), (113, 384)),
    "mixed": ((100, 40), (50, 90)),
    "width_unchanged": ((64, 48), (48, 20)),
    "height_unchanged": ((33, 80), (17, 33)),
    "large_down": ((777, 513), (384, 253)),
    "same_size": ((32, 32), (32, 32)),
}


@pytest.mark.parametrize("case", list(RESIZES))
def test_bicubic_resize_matches_pil(case):
    """``pil_bicubic_resize`` against Pillow's ``Image.resize(size,
    BICUBIC)`` on random RGB uint8: bit-exact."""
    (h, w), size = RESIZES[case]
    img = np.random.default_rng(len(case)).integers(0, 256, (h, w, 3)).astype(np.uint8)
    ref = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC))
    out = pil_bicubic_resize(img, size)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("hw", [(40, 64), (64, 40), (384, 384), (500, 300), (8, 90)])
def test_image_processor_matches_jax(hw):
    """Resize of the longest side, square padding on the mean colour, and
    the float pixels: uint8 equal, float pixels equal (same float32 ops)."""
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3)).astype(np.uint8)
    for size in (32, 384):
        j, t = JImageProcessor(image_size=size), ImageProcessor(image_size=size)
        np.testing.assert_array_equal(t.process_one_u8(img),
                                      j.process_one_u8(Image.fromarray(img)))
        np.testing.assert_array_equal(t.process_one(img),
                                      j.process_one(Image.fromarray(img)))
    assert t([]).shape == j([]).shape == (0, 384, 384, 3)
    assert t.default_shape == j.default_shape


def _convs(image_tag=True):
    tag = "<image_placeholder>\n" if image_tag else ""
    return [
        [{"role": "<|User|>", "content": f"{tag}Is there a dog? Please answer "
          "'yes' or 'no' without explanation."},
         {"role": "<|Assistant|>", "content": ""}],
        [{"role": "<|User|>", "content": f"{tag}{tag}Two images, one question?"},
         {"role": "<|Assistant|>", "content": ""}],
        [{"role": "<|User|>", "content": "No image here."},
         {"role": "<|Assistant|>", "content": ""}],
    ]


def test_processor_process_one_and_batchify_match_jax():
    """Expanded ids, ``images_seq_mask``, ``images_emb_mask``, attention
    masks and pixels equal the JAX processor's, for rows with one, two and
    no images, with the default and an explicit system prompt."""
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (24, 40, 3)).astype(np.uint8) for _ in range(3)]
    jp = JProcessor(JByteTokenizer(512), JImageProcessor(image_size=32),
                    num_image_tokens=4)
    tp = Processor(ByteTokenizer(512), ImageProcessor(image_size=32),
                   num_image_tokens=4)
    for attr in ("image_id", "image_start_id", "image_end_id", "pad_id",
                 "num_image_tokens"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    jouts, touts = [], []
    for conv, n_img in zip(_convs(), (1, 2, 0)):
        for system in (None, "Short system."):
            j = jp.process_one(conversations=conv, system_prompt=system,
                               images=[Image.fromarray(i) for i in imgs[:n_img]])
            t = tp.process_one(conversations=conv, system_prompt=system,
                               images=imgs[:n_img])
            assert t.sft_format == j.sft_format
            np.testing.assert_array_equal(t.input_ids, j.input_ids)
            np.testing.assert_array_equal(t.pixel_values, j.pixel_values)
            assert t.num_image_tokens == j.num_image_tokens
            jouts.append(j)
            touts.append(t)
    jb, tb = jp.batchify(jouts), tp.batchify(touts)
    for f in ("input_ids", "attention_mask", "pixel_values", "images_seq_mask",
              "images_emb_mask"):
        a, b = getattr(tb, f), getattr(jb, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tb.sft_format == jb.sft_format


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def _compare_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _compare_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _compare_trees(x, y, f"{path}/{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=path)


def test_load_janus_understanding_matches_jax(tmp_path):
    """A tiny synthetic checkpoint (all 2 SigLIP blocks, the attention pool,
    the aligner): the port's understanding tensors equal the JAX loader's,
    the vision config fields agree, and the key-coverage audit passes on a
    full load, skips dropped parts by name, and fails on a stray key."""
    import json

    from safetensors.torch import load_file, save_file

    from ospo_tpu.models import weights as jweights
    from ospo_tpu.models.synthetic import write_synthetic_checkpoint
    from ospo_tpu_torch.models import weights as tweights

    cfg = jjanus.tiny_janus_config()
    path = write_synthetic_checkpoint(str(tmp_path / "ckpt"), cfg, seed=0)
    jmodel = jweights.load_janus(path, use_cache=False)
    tmodel = tweights.load_janus(path, device="cpu", lm_head=True)
    for f in ("image_size", "patch_size", "width", "layers", "heads",
              "mlp_ratio", "select_layer"):
        assert getattr(tmodel.cfg.vision, f) == getattr(jmodel.cfg.vision, f), f
    assert tmodel.cfg.aligner_depth == jmodel.cfg.aligner_depth
    ref = from_jax_params(jax.tree.map(np.asarray, {
        k: jmodel.params[k] for k in ("vision_model", "aligner")}))
    assert "attn_pool" in ref["vision_model"]
    _compare_trees({k: tmodel.params[k] for k in ("vision_model", "aligner")}, ref)

    ck = tweights._Checkpoint(path, torch.device("cpu"))
    keys = set(ck.keys())
    assert tweights.check_key_coverage(keys, tmodel.cfg, keys)["consumed"] == len(keys)
    bare = tweights.load_janus(path, device="cpu", understanding=False)
    assert not {"vision_model", "aligner"} & set(bare.params)
    # select_layer -2 leaves the last block unread, by name
    conf = json.loads((tmp_path / "ckpt" / "config.json").read_text())
    conf["vision_config"]["params"]["select_layer"] = -2
    (tmp_path / "ckpt" / "config.json").write_text(json.dumps(conf))
    short = tweights.load_janus(path, device="cpu")
    assert short.params["vision_model"]["blocks"]["wqkv"].shape[0] == 1
    # a key nobody reads fails the audit
    shard = sorted((tmp_path / "ckpt").glob("*.safetensors"))[0]
    tensors = load_file(str(shard))
    tensors["vision_model.vision_tower.extra.weight"] = torch.zeros(2)
    save_file(tensors, str(shard))
    with pytest.raises(ValueError, match="key-coverage audit failed"):
        tweights.load_janus(path, device="cpu")


# ---------------------------------------------------------------------------
# the attention repairs
# ---------------------------------------------------------------------------

def test_auto_attention_keeps_head_dim_64_off_the_flash_path(monkeypatch):
    """``impl="auto"`` takes flash where the JAX dispatcher would (offset 0,
    T == S > 1, head dim 128) and the plain form elsewhere: a SigLIP-L
    head dim of 64 never reaches the flash entry.  An explicit
    ``impl="flash"`` at head dim 64 on a device is a ValueError."""
    from ospo_tpu_torch.ops import flash_attention as fa

    calls = []

    def flash_spy(q, k, v, mask=None, causal=True):
        calls.append(q.shape[-1])
        return fa.flash_attention_plain(q, k, v, mask, causal)[0]

    monkeypatch.setattr(fa, "flash_attention_train", flash_spy)
    g = torch.Generator().manual_seed(0)
    for dh in (64, 128):
        q, k, v = (torch.randn((2, 12, 4, dh), generator=g) for _ in range(3))
        out = tattn.attention(q, k, v, mask=None, causal=False)
        torch.testing.assert_close(out, tattn.xla_attention(q, k, v, None,
                                                            causal=False))
    assert calls == [128]
    q = torch.randn((1, 1, 4, 128), generator=g)
    tattn.attention(q, q, q)                   # T == 1: plain
    assert calls == [128]
    # off the CPU the kernel would be reached: refused before it (meta
    # tensors stand in for the card's); on the CPU the plain version runs
    q, k, v = (torch.empty((2, 12, 4, 64), device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="head dim 64"):
        tattn.attention(q, k, v, impl="flash")
    q, k, v = (torch.randn((2, 12, 4, 64), generator=g) for _ in range(3))
    tattn.attention(q, k, v, impl="flash")
    assert calls == [128, 64]


def _shbd_case(dtype, quantized, prefix, seed=0):
    """A cache ``[L, S, H, B, Dh]`` (bf16/fp32 values, or int8 with fp32
    scales), a left-padded window mask, T new query rows at offset
    ``cache_len`` and, optionally, a batch-shared prefix segment."""
    rng = np.random.default_rng(seed)
    L, S, H, B, Dh, T, cache_len, C = 2, 24, 4, 3, 32, 6, 14, 5
    if quantized:
        kq = rng.integers(-127, 128, (L, S, H, B, Dh)).astype(np.int8)
        vq = rng.integers(-127, 128, (L, S, H, B, Dh)).astype(np.int8)
        ks = (rng.random((L, S, H, B)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((L, S, H, B)) * 0.02 + 0.001).astype(np.float32)
    else:
        kq = rng.standard_normal((L, S, H, B, Dh)).astype(np.float32)
        vq = rng.standard_normal((L, S, H, B, Dh)).astype(np.float32)
        ks = vs = None
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, :4] = 0
    mask[2, :9] = 0
    pre = None
    if prefix:
        pre = (rng.standard_normal((C, H, Dh)).astype(np.float32),
               rng.standard_normal((C, H, Dh)).astype(np.float32),
               np.array([[0, 1, 1, 1, 1]], np.int32))
    return q, kq, vq, ks, vs, mask, cache_len, pre


@pytest.mark.parametrize("prefix", [False, True], ids=["own", "prefix"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_cached_multi_token_step_matches_xla_attention(cache, prefix):
    """A cached T > 1 step on the ``shbd`` cache as ``llama.forward`` reads
    it (``_cache_window`` over rows ``[0, cache_len + T)``, then
    ``xla_attention`` with ``kv_layout="shbd"`` at offset ``cache_len``)
    against ``ospo_tpu``'s ``xla_attention`` with
    ``kv_layout="shbd"`` over the whole window, layer 1: a bf16 cache with
    bf16 queries (tolerance one bf16 step, 2^-7 |ref| + 1e-6) and an int8
    ``{q, s}`` cache with fp32 queries (1e-5), each without and with a
    batch-shared prefix."""
    q, kq, vq, ks, vs, mask, cache_len, pre = _shbd_case(
        np.float32, cache == "int8", prefix)
    li = 1
    if cache == "int8":
        jk = {"q": kq[li], "s": np.transpose(ks[li], (2, 1, 0))}
        jv = {"q": vq[li], "s": np.transpose(vs[li], (2, 1, 0))}
        jq, tq = q, torch.as_tensor(q)
        tk, tv = torch.as_tensor(kq), torch.as_tensor(vq)
        tol = dict(atol=1e-5, rtol=1e-5)
    else:
        jq = jnp.asarray(q, jnp.bfloat16)
        jk, jv = jnp.asarray(kq[li], jnp.bfloat16), jnp.asarray(vq[li], jnp.bfloat16)
        tq = torch.as_tensor(q).bfloat16()
        tk, tv = torch.as_tensor(kq).bfloat16(), torch.as_tensor(vq).bfloat16()
        tol = dict(atol=1e-6, rtol=2 ** -7)
    jpre, tpre = {}, {}
    if pre is not None:
        jpre = dict(prefix_k=pre[0], prefix_v=pre[1], prefix_mask=pre[2])
        tpre = dict(prefix_k=torch.as_tensor(pre[0]),
                    prefix_v=torch.as_tensor(pre[1]),
                    prefix_mask=torch.as_tensor(pre[2]))
    ref = np.asarray(jxla_attention(jq, jk, jv, mask, cache_len, True,
                                         kv_layout="shbd", **jpre),
                     dtype=np.float32)
    cache = {"k": tk, "v": tv}
    if ks is not None:
        cache.update(k_s=torch.as_tensor(ks), v_s=torch.as_tensor(vs))
    cur = cache_len + q.shape[1]
    tk_w, tv_w = tllama._cache_window(cache, li, "shbd", cur)
    tmask = torch.as_tensor(mask)[:, :cur]

    def read():
        return tattn.xla_attention(tq, tk_w, tv_w, tmask, cache_len, True,
                                   kv_layout="shbd", **tpre)

    out = read()
    assert out.dtype == tq.dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)
    # row chunks change nothing but the memory held
    old = tattn.PREFIX_SCORE_ELEMS
    try:
        tattn.PREFIX_SCORE_ELEMS = 1
        again = read()
    finally:
        tattn.PREFIX_SCORE_ELEMS = old
    torch.testing.assert_close(again, out, atol=0, rtol=0)
