"""The port's step-5 slice (SimPO training of LoRA adapters) against the JAX
package on the CPU, at tiny fp32 sizes with numpy-seeded inputs.

The JAX trainer is compiled once (a module-scoped fixture); the port runs
the plain versions of its kernels here (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernels against them on the card).
"""

import importlib.util
import io
import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ospo_tpu.image_processing import ImageProcessor as JImageProcessor
from ospo_tpu.models import janus as jjanus
from ospo_tpu.models import llama as jllama
from ospo_tpu.models import vqgan as jvq
from ospo_tpu.ops.pixels import normalize_pixels as jnormalize
from ospo_tpu.processing import Processor as JProcessor
from ospo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from ospo_tpu.train import checkpoint as jckpt
from ospo_tpu.train import lora as jlora
from ospo_tpu.train import optim as joptim
from ospo_tpu.train import simpo as jsimpo
from ospo_tpu_torch.config import Config, load_yaml
from ospo_tpu_torch.image_processing import ImageProcessor
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models import llama as tllama
from ospo_tpu_torch.models import vqgan as tvq
from ospo_tpu_torch.models.weights import from_jax_params
from ospo_tpu_torch.ops import quant as tquant
from ospo_tpu_torch.ops.pixels import normalize_pixels
from ospo_tpu_torch.processing import Processor
from ospo_tpu_torch.tokenizer import ByteTokenizer
from ospo_tpu_torch.train import checkpoint as tckpt
from ospo_tpu_torch.train import lora as tlora
from ospo_tpu_torch.train import optim as toptim
from ospo_tpu_torch.train import simpo as tsimpo
from ospo_tpu_torch.train import trainer as trainer_mod
from ospo_tpu_torch.train.trainer import SimPOTrainer
from ospo_tpu_torch.utils.png import decode_png, write_png
from test_torch_models import np_janus_params

torch.set_num_threads(2)
# torch's CPU exp (MKL's vector math) sets itself up on its first call; in
# some processes the worker thread's share of that first parallel call came
# out ~1e-4 off, and every later call was exact: make that call here, once on
# this thread and once spread over both threads
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np_lora(cfg, rank, seed, b_scale=0.05):
    """A LoRA tree in the JAX layout with non-zero B (so A has gradients)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, (d_in, d_out) in tlora.proj_widths(cfg).items():
        tree[name] = {
            "a": (rng.uniform(-1, 1, (cfg.num_layers, d_in, rank))
                  / d_in ** 0.5).astype(np.float32),
            "b": (rng.standard_normal((cfg.num_layers, rank, d_out))
                  * b_scale).astype(np.float32)}
    return tree


def _torch_lora(tree):
    """The port's LoRA tree (fp32 torch leaves; same layout) of a numpy one."""
    return {n: {k: torch.as_tensor(x).float() for k, x in ab.items()}
            for n, ab in tree.items()}


def _close_trees(got, ref, rel):
    """max|got − ref| ≤ rel · max|ref| for every leaf."""
    for n in ref:
        for k in ref[n]:
            g = np.asarray(got[n][k].detach() if torch.is_tensor(got[n][k])
                           else got[n][k], np.float64)
            r = np.asarray(ref[n][k], np.float64)
            scale = max(np.abs(r).max(), 1e-30)
            assert np.abs(g - r).max() <= rel * scale, (n, k, np.abs(g - r).max(), scale)


# ---------------------------------------------------------------------------
# LoRA in the trunk
# ---------------------------------------------------------------------------


def test_maybe_lora_matches_jax():
    """Base product plus scaling·(x@A)@B, for a float and an int8 weight
    and for a projection without an adapter; fp32, tolerance 1e-6 of the
    outputs' scale (max |y| ≈ 30; summation order)."""
    from ospo_tpu.ops import quant as jquant

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16), np.float32)
    w = rng.standard_normal((12, 16), np.float32)
    lora = {"q_proj": {"a": rng.standard_normal((16, 4), np.float32),
                       "b": rng.standard_normal((4, 12), np.float32)}}
    jl = jax.tree.map(jnp.asarray, lora)
    tl = jax.tree.map(_t, lora)
    qw = jquant.quantize_matrix(jnp.asarray(w))
    for name in ("q_proj", "k_proj"):
        for jw, tw in ((jnp.asarray(w), _t(w)),
                       (qw, {k: _t(v) for k, v in qw.items()})):
            ref = jllama._maybe_lora(jnp.asarray(x), jw, jl, name, 2.0)
            got = tllama._maybe_lora(_t(x), tw, tl, name, 2.0)
            scale = float(np.abs(np.asarray(ref)).max())
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-6 * scale, rtol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_lora_forward_and_backward_match_jax(remat):
    """``llama.forward`` with LoRA (no cache, all-ones mask): hidden states
    and the adapters' gradients of a fixed cotangent, against
    ``jax.value_and_grad`` of the JAX forward with and without remat.  The
    port runs the flash path (plain forward and backward), JAX its XLA
    attention.  fp32; hidden within 1e-4, gradients within 1e-4·max|g|."""
    cfg_j, cfg_t = jllama.tiny_config(), tllama.tiny_config()
    jp = jllama.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = from_jax_params({"language_model": jax.tree.map(np.asarray, jp)}
                         )["language_model"]
    lora = _np_lora(cfg_t, 4, 1)
    rng = np.random.default_rng(2)
    B, T = 2, 9
    x = rng.standard_normal((B, T, cfg_j.hidden_size), np.float32)
    cot = rng.standard_normal((B, T, cfg_j.hidden_size), np.float32)
    mask = np.ones((B, T), np.int32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)

    def jloss(tree):
        h, _ = jllama.forward(jp, cfg_j, jnp.asarray(x), jnp.asarray(mask),
                              jnp.asarray(pos), lora=tree, lora_scaling=2.0,
                              remat=remat, attn_impl="xla")
        return jnp.sum(h * jnp.asarray(cot)), h

    (_, jh), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, lora))
    tl = {n: {k: _t(v).requires_grad_(True) for k, v in ab.items()}
          for n, ab in lora.items()}
    th, _ = tllama.forward(tp, cfg_t, _t(x), _t(mask), _t(pos), lora=tl,
                           lora_scaling=2.0, remat=remat, attn_impl="flash")
    leaves = [tl[n][k] for n in tl for k in ("a", "b")]
    grads = torch.autograd.grad((th * _t(cot)).sum(), leaves)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               atol=1e-4, rtol=1e-4)
    tg = {n: {k: grads[2 * i + j] for j, k in enumerate(("a", "b"))}
          for i, n in enumerate(tl)}
    _close_trees(tg, jax.tree.map(np.asarray, jg), 1e-4)


def test_lora_dropout_statistics_and_recompute():
    """Dropout on the adapter input only: with identity adapters and a zero
    base weight the output IS the dropped input, so the kept share is
    1 − p within 5 sigma and kept values are scaled by 1/(1 − p); one seed
    and projection give one mask, another projection or seed another.  In
    ``llama.forward`` a checkpointed layer's recompute redraws the same
    masks: remat and no remat give equal hidden states and gradients."""
    p, n = 0.3, 256
    x = torch.ones((4, 64, n))
    eye = {"a": torch.eye(n), "b": torch.eye(n)}
    w = torch.zeros((n, n))
    y = tllama._maybe_lora(x, w, {"q_proj": eye}, "q_proj", 1.0, p, 7)
    kept = float((y != 0).float().mean())
    sigma = (p * (1 - p) / y.numel()) ** 0.5
    assert abs(kept - (1 - p)) < 5 * sigma, kept
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - p)))
    again = tllama._maybe_lora(x, w, {"q_proj": eye}, "q_proj", 1.0, p, 7)
    assert torch.equal(y, again)
    other = tllama._maybe_lora(x, w, {"k_proj": eye}, "k_proj", 1.0, p, 7)
    reseed = tllama._maybe_lora(x, w, {"q_proj": eye}, "q_proj", 1.0, p, 8)
    assert not torch.equal(y, other) and not torch.equal(y, reseed)

    cfg = tllama.tiny_config()
    tp = from_jax_params({"language_model": jax.tree.map(
        np.asarray, jllama.init_params(jllama.tiny_config(),
                                       jax.random.PRNGKey(3)))})["language_model"]
    lora = _np_lora(cfg, 4, 4)
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 7, cfg.hidden_size), np.float32))
    mask = torch.ones((2, 7), dtype=torch.int32)
    pos = torch.arange(7).expand(2, 7)
    out = []
    for remat in (False, True):
        tl = {n: {k: _t(v).requires_grad_(True) for k, v in ab.items()}
              for n, ab in lora.items()}
        h, _ = tllama.forward(tp, cfg, x, mask, pos, lora=tl, lora_scaling=2.0,
                              lora_dropout=p, lora_dropout_seed=11,
                              remat=remat, attn_impl="flash")
        g = torch.autograd.grad(h.pow(2).sum(), [tl[n]["a"] for n in tl])
        out.append((h.detach(), g))
    torch.testing.assert_close(out[0][0], out[1][0], atol=0, rtol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_init_lora_bound_and_shapes():
    """Shapes of the JAX init; A uniform within ±1/√d_in (sample std within
    15% of bound/√3), B zeros, fp32."""
    cfg_j, cfg_t = jllama.tiny_config(), tllama.tiny_config()
    lcfg_t = tlora.LoraConfig(rank=4, alpha=8)
    ref = jax.eval_shape(lambda k: jlora.init_lora(
        cfg_j, jlora.LoraConfig(rank=4, alpha=8), k), jax.random.PRNGKey(0))
    tree = tlora.init_lora(cfg_t, lcfg_t, seed=0)
    assert set(tree) == set(ref)
    for name, ab in tree.items():
        d_in = tlora.proj_widths(cfg_t)[name][0]
        bound = d_in ** -0.5
        assert ab["a"].shape == ref[name]["a"].shape and ab["a"].dtype == torch.float32
        assert ab["b"].shape == ref[name]["b"].shape and not ab["b"].any()
        assert float(ab["a"].abs().max()) <= bound
        assert abs(float(ab["a"].std()) - bound / 3 ** 0.5) < 0.15 * bound / 3 ** 0.5


def test_merge_matches_jax():
    """Adapters folded into the stacked fp32 weights (in place in the
    port); tolerance 1e-6."""
    cfg = jllama.tiny_config()
    jp = jax.tree.map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(6)))
    lora = _np_lora(tllama.tiny_config(), 4, 7)
    ref = jlora.merge(jax.tree.map(jnp.asarray, jp), jax.tree.map(
        jnp.asarray, lora), 2.0)
    tp = from_jax_params({"language_model": jp})["language_model"]
    got = tlora.merge(tp, lora, 2.0)
    assert got is tp
    for name in tlora.PROJ_TO_PARAM.values():
        np.testing.assert_allclose(got["layers"][name].numpy(),
                                   np.asarray(ref["layers"][name]),
                                   atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# VQ encode and pixels
# ---------------------------------------------------------------------------


def test_vq_encode_to_ids_matches_jax():
    """Encoder latents within 1e-4 (fp32 convolutions); the ids equal
    JAX's except at near-ties, where the two codes' distances agree within
    1e-6 relative — counted, and none expected at this size."""
    cfg = jjanus.tiny_janus_config()
    params = np_janus_params(cfg, 8)
    tp = from_jax_params(params)["gen_vision_model"]
    jp = jax.tree.map(jnp.asarray, params["gen_vision_model"])
    px = np.random.default_rng(9).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    ref_ids = np.asarray(jax.jit(lambda p, x: jvq.encode_to_ids(p, cfg.vq, x))(
        jp, jnp.asarray(px)))
    ids = tvq.encode_to_ids(tp, tvq.tiny_vq_config(), _t(px)).numpy()
    assert ids.shape == ref_ids.shape == (3, 256)
    jz = np.asarray(jvq.conv2d(jp["quant_conv"], jvq.encoder_forward(
        jp["encoder"], cfg.vq, jnp.asarray(px))))
    tz = tvq.conv2d(tp["quant_conv"], tvq.encoder_forward(
        tp["encoder"], tvq.tiny_vq_config(), _t(px).permute(0, 3, 1, 2)))
    tz = tz.permute(0, 2, 3, 1)
    np.testing.assert_allclose(tz.numpy(), jz, atol=1e-4, rtol=1e-4)
    zn, _, _ = tvq._nearest_code(tp, tvq.tiny_vq_config(), tz)
    zn = zn.reshape(-1, zn.shape[-1]).double()
    cb = tvq.normalized_codebook(tp, tvq.tiny_vq_config()).double()
    differ = np.flatnonzero(ids.reshape(-1) != ref_ids.reshape(-1))
    for i in differ:
        d = ((zn[i] - cb[[ids.flat[i], ref_ids.flat[i]]]) ** 2).sum(-1)
        assert abs(float(d[0] - d[1])) <= 1e-6 * float(d.abs().max()), i
    assert len(differ) == 0, f"{len(differ)} near-tie ids differ"


@pytest.mark.parametrize("do_normalize", [True, False])
def test_normalize_pixels_matches_jax(do_normalize):
    """uint8 → fp32 with the processor's constants; float passes through.
    Same fp32 operations in the same order; tolerance 1e-6."""
    px = np.random.default_rng(10).integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    kw = dict(image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
              do_normalize=do_normalize)
    ref = jnormalize(jnp.asarray(px), JImageProcessor(**kw))
    got = normalize_pixels(_t(px), ImageProcessor(**kw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    f = torch.rand((1, 4, 4, 3))
    assert normalize_pixels(f, ImageProcessor()) is f


def test_image_processor_passes_same_size_and_refuses_others(tmp_path):
    """A 32×32 RGB image comes out of the port's processor exactly as out
    of PIL's same-size resize, a 30×32 one as out of PIL's bicubic resize
    and square padding; a checkpoint's preprocessor_config.json is read as
    the JAX loader reads it."""
    from PIL import Image

    from ospo_tpu.image_processing import load_image_processor as jload
    from ospo_tpu_torch.image_processing import load_image_processor

    img = np.random.default_rng(11).integers(0, 256, (32, 32, 3)).astype(np.uint8)
    ref = JImageProcessor(image_size=32).process_one_u8(Image.fromarray(img))
    np.testing.assert_array_equal(ImageProcessor(image_size=32).process_one_u8(img),
                                  ref)
    np.testing.assert_array_equal(
        ImageProcessor(image_size=32).process_one_u8(img[:, :30]),
        JImageProcessor(image_size=32).process_one_u8(Image.fromarray(img[:, :30])))
    (tmp_path / "preprocessor_config.json").write_text(json.dumps(
        {"image_size": 48, "image_mean": [0.5] * 3, "image_std": [0.5] * 3}))
    a, b = jload(str(tmp_path)), load_image_processor(str(tmp_path))
    for f in ("image_size", "image_mean", "image_std", "rescale_factor",
              "do_normalize", "background_color"):
        assert getattr(a, f) == getattr(b, f), f


def _filtered_png(img: np.ndarray) -> bytes:
    """An RGB PNG whose rows cycle through all five filter types."""
    h, w, _ = img.shape
    bpp, rows, prior = 3, [], np.zeros(w * 3, np.int64)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        ft = y % 5
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_read_png_matches_pillow(tmp_path):
    """Bit-exact against Pillow: random and smooth images Pillow saved as
    grey, RGB and RGBA (its adaptive filters), and an RGB PNG using all five
    row filters, each read as RGB."""
    from PIL import Image

    rng = np.random.default_rng(12)
    y, x = np.mgrid[0:40, 0:33]
    blobs = []
    for mode, c in (("L", 1), ("RGB", 3), ("RGBA", 4)):
        smooth = np.stack([(x * 3 + y * 5 + 17 * k) % 256 for k in range(c)], -1)
        for arr in (rng.integers(0, 256, (37, 29, c)), smooth):
            arr = arr.astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(buf, "PNG")
            blobs.append(buf.getvalue())
    img = rng.integers(0, 256, (23, 19, 3)).astype(np.uint8)
    blobs.append(_filtered_png(img))
    for data in blobs:
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), ref)
    np.testing.assert_array_equal(decode_png(blobs[-1]), img)
    path = tmp_path / "a.png"
    write_png(str(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


# ---------------------------------------------------------------------------
# loss and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_type,sft", [("sigmoid", 0.0), ("hinge", 0.0),
                                           ("sigmoid", 0.5)])
def test_simpo_loss_metrics_and_gradient_match_jax(loss_type, sft):
    """Loss, every metric (same names) and d loss / d logits; fp32,
    tolerance 1e-5 relative."""
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((4, 10, 16)).astype(np.float32) * 3
    labels = rng.integers(0, 16, (4, 10))
    labels[:, :4] = -100
    jcfg = jsimpo.SimPOConfig(beta=10.0, gamma_beta_ratio=0.5,
                              label_smoothing=0.1, sft_weight=sft,
                              loss_type=loss_type)
    tcfg = tsimpo.SimPOConfig(beta=10.0, gamma_beta_ratio=0.5,
                              label_smoothing=0.1, sft_weight=sft,
                              loss_type=loss_type)
    (jl, jm), jg = jax.value_and_grad(
        lambda lg: jsimpo.loss_and_metrics(jcfg, lg, jnp.asarray(labels)),
        has_aux=True)(jnp.asarray(logits))
    tlog = _t(logits).requires_grad_(True)
    tl, tm = tsimpo.loss_and_metrics(tcfg, tlog, _t(labels))
    (tg,) = torch.autograd.grad(tl, tlog)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("sched", ["constant", "cosine", "cosine_restarts"])
def test_schedules_match_jax(sched):
    """The LR at steps 0..40 of a 30-step run with 20% warmup; tolerance
    1e-6 relative plus 1e-6·init_lr absolute (the JAX schedules run in
    fp32, whose cosine near its minimum rounds at ~1e-11 here)."""
    ref = {"constant": lambda s: 3e-4,
           "cosine": joptim.cosine_decay_warmup(3e-4, 6, 30, 1e-6),
           "cosine_restarts": joptim.cosine_annealing_warmup_restarts(
               30, 3e-4, 1e-6, 6)}[sched]
    got = toptim.make_schedule(sched, 3e-4, 30, 0.2, 1e-6)
    for s in range(41):
        np.testing.assert_allclose(got(s), float(ref(s)), rtol=1e-6,
                                   atol=1e-6 * 3e-4, err_msg=s)


@pytest.mark.parametrize("sched,wd,accum,clip", [
    ("constant", 0.0, 1, 1.0), ("cosine", 0.1, 2, 0.5),
    ("cosine_restarts", 0.0, 1, None)])
def test_optimizer_chain_matches_optax(sched, wd, accum, clip):
    """clip → fp32 → AdamW (→ MultiSteps) against the JAX package's
    ``build_optimizer`` on the same gradients for 6 micro-steps, some above
    the clip norm; parameters within 1e-6 relative (fp32 rounding)."""
    rng = np.random.default_rng(14)
    params = {"q_proj": {"a": rng.standard_normal((2, 3, 4)).astype(np.float32),
                         "b": rng.standard_normal((2, 4, 5)).astype(np.float32)}}
    jtx = joptim.build_optimizer(init_lr=3e-2, betas=(0.9, 0.95),
                                 weight_decay=wd, eps=1e-8,
                                 scheduler_type=sched, max_steps=5,
                                 warmup_ratio=0.2, grad_clip=clip,
                                 accumulation_steps=accum)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jparams)
    tparams = jax.tree.map(_t, params)
    opt = toptim.AdamW(tparams, toptim.make_schedule(sched, 3e-2, 5, 0.2),
                       betas=(0.9, 0.95), eps=1e-8, weight_decay=wd,
                       grad_clip=clip, accumulation_steps=accum)
    for step in range(6):
        scale = 3.0 if step % 2 else 0.05
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                        * scale).astype(np.float32), params)
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, upd)
        applied = opt.step(tparams, jax.tree.map(_t, grads))
        assert applied == ((step + 1) % accum == 0)
        for k in ("a", "b"):
            np.testing.assert_allclose(tparams["q_proj"][k].numpy(),
                                       np.asarray(jparams["q_proj"][k]),
                                       rtol=1e-6, atol=1e-7, err_msg=(step, k))
    assert opt.count == 6 // accum


# ---------------------------------------------------------------------------
# one trainer step against SimPOTrainer._step
# ---------------------------------------------------------------------------

LR = 1e-3


def _trainer_config(tmp, attn_impl, **exp):
    return {
        "base": {"save_path": str(tmp), "exp_name": "t"},
        "use_peft": True,
        "lora": {"lora_rank": 4, "lora_alpha": 8, "lora_dropout": 0.0},
        "optimizer": {"init_lr": LR, "scheduler_type": "constant"},
        "experiment": {"seed": 0, "max_training_steps": 8, "log_steps": 1,
                       "gradient_checkpointing": True,
                       "attn_impl": attn_impl, **exp},
        "algo": {"beta": 10, "gamma_beta_ratio": 0.5, "loss_type": "sigmoid",
                 "sft_weight": 0.3},
    }


def _batch(seed=15, b=2, t=32):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, t), np.float32)
    mask[1, 21:] = 0                        # right padding
    ids = rng.integers(0, 256, (b, t)).astype(np.int32) * mask.astype(np.int32)
    return (ids, mask,
            rng.integers(0, 256, (b, 32, 32, 3)).astype(np.uint8),
            rng.integers(0, 256, (b, 32, 32, 3)).astype(np.uint8))


def _port_model(params):
    return tjanus.JanusModel(tjanus.tiny_janus_config(), from_jax_params(params),
                             torch.device("cpu"))


def _port_processor():
    return Processor(ByteTokenizer(512), ImageProcessor(image_size=32))


def _jax_lora_step(tmp, **exp):
    """One ``SimPOTrainer._step`` of the JAX package (XLA attention, remat,
    dropout 0) on a tiny model: metrics, exact gradients (captured from the
    update chain) and the parameters after one AdamW update."""
    from ospo_tpu.config import Config as JConfig
    from ospo_tpu.train.trainer import SimPOTrainer as JTrainer

    cfg = jjanus.tiny_janus_config()
    params = np_janus_params(cfg, 16)
    jmodel = jjanus.JanusModel(cfg, jax.tree.map(jnp.asarray, params))
    jproc = JProcessor(JByteTokenizer(512), JImageProcessor(image_size=32),
                       num_image_tokens=cfg.num_image_tokens)
    trainer = JTrainer(JConfig.from_nested(_trainer_config(tmp, "xla", **exp)),
                       jmodel, jproc)
    lora = _np_lora(tllama.tiny_config(), 4, 17)
    captured = {}

    def capture(updates, params=None):
        jax.debug.callback(lambda g: captured.update(g=g), updates)
        return jax.tree.map(jnp.zeros_like, updates)

    real_tx = trainer.tx
    trainer.tx = optax.stateless(capture)
    _, _, metrics = trainer._step(jax.tree.map(jnp.asarray, lora),
                                  trainer.opt_state, *map(jnp.asarray, _batch()))
    jax.effects_barrier()
    grads = jax.tree.map(np.asarray, captured["g"])
    jl = jax.tree.map(jnp.asarray, lora)
    upd, _ = real_tx.update(jax.tree.map(jnp.asarray, grads), real_tx.init(jl), jl)
    updated = jax.tree.map(np.asarray, optax.apply_updates(jl, upd))
    return {"params": params, "lora": lora, "grads": grads, "updated": updated,
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    return _jax_lora_step(tmp_path_factory.mktemp("j"))


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_trainer_step_matches_jax(jax_step, tmp_path, attn_impl):
    """The port's step (flash path: the backward kernels' plain versions;
    or the plain masked attention) against the JAX step on the same
    weights, adapters and batch: loss and every metric within 1e-4
    relative or 1e-5 absolute (the margins are differences of rewards of
    magnitude ~40, whose fp32 step is ~4e-6), LoRA gradients within 1e-3·max|g| per leaf (fp32 through the
    VQ encoder and the trunk), and after one update the adapters within
    1e-2·lr (Adam's first step is ±lr wherever |g| ≫ eps)."""
    trainer = SimPOTrainer(Config.from_nested(_trainer_config(tmp_path, attn_impl)),
                           _port_model(jax_step["params"]), _port_processor())
    trainer._set_trainable(jax_step["lora"])
    _, metrics, grads = trainer.loss_and_grads(*_batch())
    metrics["grad_norm"] = toptim.global_norm(grads)
    assert set(metrics) == set(jax_step["metrics"])
    for k, ref in jax_step["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    _close_trees(grads, jax_step["grads"], 1e-3)
    assert trainer.opt.step(trainer.trainable, grads)
    for n, ab in jax_step["updated"].items():
        for k, ref in ab.items():
            np.testing.assert_allclose(trainer.trainable[n][k].detach().numpy(),
                                       ref, atol=1e-2 * LR, rtol=0,
                                       err_msg=(n, k))


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """``quantize_base: int4`` (not offered by the JAX trainer) and an
    unknown spelling are ValueErrors, and so is more than one process
    without ``model.data_parallel``."""
    model = tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=0,
                                   device="cpu")
    base = _trainer_config(tmp_path, "flash")
    with pytest.raises(ValueError, match="quantize_base"):
        SimPOTrainer(Config.from_nested({**base, "experiment": {
            **base["experiment"], "quantize_base": "int4"}}), model,
            _port_processor())
    with pytest.raises(ValueError, match="quantize_base"):
        SimPOTrainer(Config.from_nested({**base, "experiment": {
            **base["experiment"], "quantize_base": "int_8"}}), model,
            _port_processor())
    monkeypatch.setattr(trainer_mod, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="data_parallel"):
        SimPOTrainer(Config.from_nested(base), model, _port_processor())


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------


def test_checkpoints_load_across_packages(tmp_path):
    """A port checkpoint loads in ``ospo_tpu.train.checkpoint`` (adapters,
    LoRA config, step) and a JAX checkpoint in the port's trainer: the
    adapters are taken, the optimizer (other keys) starts fresh."""
    lora = _np_lora(tllama.tiny_config(), 4, 18)
    cfg_t = tlora.LoraConfig(rank=4, alpha=8, dropout=0.0)
    opt = toptim.AdamW(_torch_lora(lora), lambda s: 1e-3)
    path = tckpt.save_checkpoint(str(tmp_path / "t"), 7, _torch_lora(lora),
                                 cfg_t, opt.state_dict())
    tree, jcfg, step, opt_flat = jckpt.load_checkpoint(path)
    assert step == 7 and jcfg == jlora.LoraConfig(rank=4, alpha=8, dropout=0.0)
    _close_trees(tree, lora, 0.0)
    assert "count" in opt_flat and "mu/q_proj/a" in opt_flat

    jtree = jax.tree.map(jnp.asarray, lora)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 3, jtree, jcfg,
                                  opt_state=optax.adamw(1e-3).init(jtree))
    trainer = SimPOTrainer(
        Config.from_nested(_trainer_config(tmp_path / "run", "flash")),
        tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=0, device="cpu"),
        _port_processor())
    trainer.resume(jpath)
    assert trainer.global_step == 3 and trainer.opt.count == 0
    assert trainer.lora_cfg == cfg_t
    _close_trees(trainer.trainable, lora, 0.0)
    assert all(t.requires_grad for ab in trainer.trainable.values()
               for t in ab.values())


def test_resume_is_exact(tmp_path):
    """Two steps in one run equal one step, a checkpoint, a resume and the
    second step: adapters and optimizer state bit for bit (dropout on,
    seeded per micro-step)."""
    model = tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=0, device="cpu")
    conf = _trainer_config(tmp_path / "a", "flash")
    conf["lora"]["lora_dropout"] = 0.1
    b1, b2 = _batch(19), _batch(20)
    t1 = SimPOTrainer(Config.from_nested(conf), model, _port_processor())
    t1._step(*b1, dropout_seed=1)
    t1.global_step = 1
    ckpt = t1.save()
    t1._step(*b2, dropout_seed=2)
    conf["base"]["save_path"] = str(tmp_path / "b")
    t2 = SimPOTrainer(Config.from_nested(conf), model, _port_processor())
    t2.resume(ckpt)
    t2._step(*b2, dropout_seed=2)
    _close_trees(t2.trainable, {n: {k: t.detach().numpy() for k, t in ab.items()}
                                for n, ab in t1.trainable.items()}, 0.0)
    for k, v in t1.opt.state_dict().items():
        torch.testing.assert_close(torch.as_tensor(t2.opt.state_dict()[k]),
                                   torch.as_tensor(v), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the pipeline step and the factory
# ---------------------------------------------------------------------------


def _write_step4(root, n=3):
    """A train.json with foreign absolute paths (re-rooted at image_root's
    default, ``<step4>/../step3``) and 32×32 PNGs."""
    rng = np.random.default_rng(21)
    recs = []
    for i in range(n):
        rec = {"item_id": f"{i:07d}", "category": "attribute",
               "prompt": f"A red cube number {i}" + " on a table" * i}
        for key, ptype in (("chosen", "base"), ("rejected", "negative")):
            rel = os.path.join(ptype, "attribute", f"{i:07d}", "01.png")
            os.makedirs(os.path.dirname(root / "step3" / rel), exist_ok=True)
            write_png(str(root / "step3" / rel),
                      rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))
            rec[key] = "/elsewhere/base/run/step3/" + rel
        recs.append(rec)
    (root / "step4").mkdir()
    (root / "step4" / "train.json").write_text(json.dumps(recs))
    return str(root / "step4" / "train.json")


def test_preference_dataset_matches_jax(tmp_path):
    """Tokens, uint8 pixels (PIL against the port's PNG reader), the
    re-rooting at the LAST base|negative component, the text bucket and
    the shuffled batch order."""
    from ospo_tpu.pipeline.datasets import PreferenceDataset as JDataset
    from ospo_tpu_torch.pipeline.datasets import PreferenceDataset

    path = _write_step4(tmp_path)
    jds = JDataset(0, path, JProcessor(JByteTokenizer(512),
                                       JImageProcessor(image_size=32)))
    tds = PreferenceDataset(0, path, _port_processor())
    jds.data_root = tds.data_root = str(tmp_path / "step3")
    assert len(tds) == len(jds) == 3 and tds.max_text_len() == jds.max_text_len()
    for i in range(3):
        a, b = jds[i], tds[i]
        assert a["item_id"] == b["item_id"]
        for k in ("text_tokens", "chosen_pixels", "rejected_pixels"):
            np.testing.assert_array_equal(a[k], b[k])
    order = lambda ds: [[x["item_id"] for x in batch]  # noqa: E731
                        for batch in ds.iter_batches(2, seed=5)]
    assert order(tds) == order(jds)


def test_step5_main_on_cpu(tmp_path):
    """``step5.main`` of a tiny model on the CPU over a synthetic train.json
    (3 records, batch 2, flash path): 2 optimizer steps, the checkpoint
    layout, train_stats.json, the JSONL scalars and the saved config."""
    from ospo_tpu_torch.pipeline import step5

    data_path = _write_step4(tmp_path)
    trainer = step5.main(Config.from_nested({
        "base": {"save_path": str(tmp_path / "out"), "exp_name": "ospo"},
        "model": {"model_preset": "tiny"}, "device": "cpu",
        "lora": {"lora_rank": 4, "lora_alpha": 8},
        "dataset": {"train": {"data_path": data_path, "batch_size": 2}},
        "optimizer": {"init_lr": 1e-3},
        "experiment": {"seed": 1, "max_training_steps": 5, "max_epochs": 1,
                       "log_steps": 1, "attn_impl": "flash"},
        "algo": {"beta": 10, "gamma_beta_ratio": 0.5}}))
    log = tmp_path / "out" / "ospo"
    assert trainer.global_step == 2 and len(trainer.update_seconds) == 2
    assert sorted(os.listdir(log / "step_000002")) == ["lora.npz", "meta.json",
                                                      "opt.npz"]
    stats = json.loads((log / "train_stats.json").read_text())
    assert set(stats) == {"first_update_s", "total_s", "samples",
                          "samples_per_s_wall", "samples_per_s_steady"}
    assert stats["samples"] == 3
    lines = [json.loads(x) for x in (log / "scalars.jsonl").read_text().split("\n") if x]
    assert [x["step"] for x in lines] == [1, 2]
    assert np.isfinite(lines[-1]["train/loss"]) and "train/grad_norm" in lines[-1]
    assert json.loads((log / "config.yaml").read_text())["device"] == "cpu"
    tree, _, step, _ = jckpt.load_checkpoint(str(log))
    assert step == 2 and np.abs(tree["q_proj"]["b"]).max() > 0


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_get_model_merges_ckpt_path(tmp_path, quantize):
    """``ckpt_path`` folds a LoRA checkpoint into the trunk before the int8
    quantize: the merged weights equal the JAX package's merge of the same
    base and adapters (1e-6), and the int8 trunk dequantizes to the
    quantization of that within one step (a 1e-6 merge difference may
    round a value the other way)."""
    from ospo_tpu_torch.ops import quant as tquant
    from ospo_tpu_torch.pipeline.model_factory import get_model

    lora = _np_lora(tllama.tiny_config(), 4, 22)
    lcfg = tlora.LoraConfig(rank=4, alpha=8)
    tckpt.save_checkpoint(str(tmp_path), 5, lora, lcfg)
    base = tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=42,
                                  device="cpu").params["language_model"]
    ref = jlora.merge({"layers": {k: jnp.asarray(v.numpy()) for k, v in
                                  base["layers"].items()}},
                      jax.tree.map(jnp.asarray, lora), lcfg.scaling)["layers"]
    model, _, proc = get_model({"model_preset": "tiny", "device": "cpu",
                                "ckpt_path": str(tmp_path), "quantize": quantize})
    assert proc.image_processor.image_size == 32
    for name in tlora.PROJ_TO_PARAM.values():
        got = model.params["language_model"]["layers"][name]
        want = np.asarray(ref[name])
        if quantize:
            w = got["q"].float() * got["s"][..., None]
            q = tquant.quantize_matrix(_t(want))
            np.testing.assert_allclose(w.numpy(), (q["q"].float() * q["s"][
                ..., None]).numpy(), atol=float(q["s"].max()) * 1.01, rtol=0)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_chip_smoke_step5_config_is_the_yaml_plus_named_overrides():
    """``STEP5_CONFIG`` equals ``configs/step5.yaml``; phase 5 changes only
    the named keys."""
    import yaml

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(ROOT, "configs", "step5.yaml")) as f:
        assert mod.STEP5_CONFIG == yaml.safe_load(f)

    def flat(d, pre=""):
        out = {}
        for k, v in d.items():
            out.update(flat(v, f"{pre}{k}.") if isinstance(v, dict)
                       else {f"{pre}{k}": v})
        return out

    a = flat(mod.STEP5_CONFIG)
    b = flat(mod.merged(mod.STEP5_CONFIG, mod.step5_overrides("d", "i", "s")))
    changed = {k for k in set(a) | set(b) if a.get(k, "∅") != b.get(k, "∅")}
    assert changed == {"model.model_path", "model.model_preset",
                       "experiment.attn_impl", "experiment.max_training_steps",
                       "experiment.max_epochs", "experiment.save_steps",
                       "dataset.train.data_path", "image_root", "base.save_path"}


# ---------------------------------------------------------------------------
# full fine-tune (use_peft: False) and the int8 frozen trunk (quantize_base)
# ---------------------------------------------------------------------------

# the freeze matrix of configs/step5.yaml: the language model trains
FREEZE = load_yaml(os.path.join(ROOT, "configs", "step5.yaml"))[
    "experiment"]["freeze"]


def _full_config(tmp, attn_impl="flash", freeze=None, **exp):
    conf = _trainer_config(tmp, attn_impl, **exp)
    conf["use_peft"] = False
    conf["experiment"]["freeze"] = {**FREEZE, **(freeze or {})}
    return conf


def _as_np(x):
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype.kind == "V" \
        else np.asarray(x)


def _assert_trees(got, want, atol):
    """Same structure; every leaf within ``atol`` (0: bit for bit)."""
    g, w = dict(toptim.leaves(got)), dict(toptim.leaves(want))
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:5]
    for k in w:
        a, b = _as_np(g[k]), _as_np(w[k])
        assert a.shape == b.shape, k
        if atol:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("freeze", [{}, {"gen_head": False},
                                    {"gen_vision_model": False,
                                     "language_model": True}])
def test_full_finetune_trainable_keys_match_jax(tmp_path, freeze):
    """The trained submodules are the top-level parameter keys the freeze
    matrix leaves unfrozen (a key it does not name stays frozen), as in the
    JAX trainer; their leaves are the model's own tensors, trained in
    place."""
    from ospo_tpu.config import Config as JConfig
    from ospo_tpu.train.trainer import SimPOTrainer as JTrainer

    cfg = jjanus.tiny_janus_config()
    params = np_janus_params(cfg, 24)
    conf = _full_config(tmp_path, freeze=freeze)
    jt = JTrainer(JConfig.from_nested(conf),
                  jjanus.JanusModel(cfg, jax.tree.map(jnp.asarray, params)),
                  JProcessor(JByteTokenizer(512), JImageProcessor(image_size=32)))
    model = _port_model(params)
    tt = SimPOTrainer(Config.from_nested(conf), model, _port_processor())
    assert tt.trainable_keys == jt.trainable_keys
    for k in tt.trainable_keys:
        assert tt.trainable[k] is model.params[k]
        assert all(t.requires_grad for _, t in toptim.leaves(tt.trainable[k]))


def _jax_full_step(tmp):
    """One full-mode ``SimPOTrainer._step`` of the JAX package (the language
    model and the gen head trained, XLA attention, remat): the metrics, the
    exact gradients (captured from the update chain) and the trained
    submodules after one AdamW update."""
    from ospo_tpu.config import Config as JConfig
    from ospo_tpu.train.trainer import SimPOTrainer as JTrainer

    cfg = jjanus.tiny_janus_config()
    params = np_janus_params(cfg, 25)
    jproc = JProcessor(JByteTokenizer(512), JImageProcessor(image_size=32),
                       num_image_tokens=cfg.num_image_tokens)
    trainer = JTrainer(JConfig.from_nested(_full_config(
        tmp, "xla", {"gen_head": False})),
        jjanus.JanusModel(cfg, jax.tree.map(jnp.asarray, params)), jproc)
    captured = {}

    def capture(updates, params=None):
        jax.debug.callback(lambda g: captured.update(g=g), updates)
        return jax.tree.map(jnp.zeros_like, updates)

    real_tx = trainer.tx
    trainer.tx = optax.stateless(capture)
    start = jax.tree.map(np.array, trainer.trainable)
    _, _, metrics = trainer._step(trainer.trainable, trainer.opt_state,
                                  *map(jnp.asarray, _batch()))
    jax.effects_barrier()
    grads = jax.tree.map(np.asarray, captured["g"])
    jt = jax.tree.map(jnp.asarray, start)
    upd, _ = real_tx.update(jax.tree.map(jnp.asarray, grads), real_tx.init(jt), jt)
    return {"params": params, "grads": grads,
            "updated": jax.tree.map(np.asarray, optax.apply_updates(jt, upd)),
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def jax_full_step(tmp_path_factory):
    return _jax_full_step(tmp_path_factory.mktemp("jf"))


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_full_finetune_step_matches_jax(jax_full_step, tmp_path, attn_impl):
    """One full-mode step against the JAX package's on the same weights and
    batch: loss and every metric (grad_norm included) within 1e-4 relative
    or 1e-5 absolute; the gradient of every trained leaf within
    1e-3·max|g|; after the update, every trained element within 1e-2·lr
    where the JAX gradient exceeds 100·eps (there Adam's first step is ±lr
    within 1%; where |g| is near eps the step is |g|/(|g| + eps)·lr, which
    amplifies fp32 rounding of g, and the gradient check holds those
    elements)."""
    model = _port_model(jax_full_step["params"])
    trainer = SimPOTrainer(Config.from_nested(_full_config(
        tmp_path, attn_impl, {"gen_head": False})), model, _port_processor())
    assert trainer.trainable_keys == ["gen_head", "language_model"]
    _, metrics, grads = trainer.loss_and_grads(*_batch())
    metrics["grad_norm"] = toptim.global_norm(grads)
    assert set(metrics) == set(jax_full_step["metrics"])
    for k, ref in jax_full_step["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    ref_g = dict(toptim.leaves(from_jax_params(jax_full_step["grads"])))
    got_g = dict(toptim.leaves(grads))
    assert set(got_g) == set(ref_g)
    for k, r in ref_g.items():
        scale = max(float(r.abs().max()), 1e-30)
        assert float((got_g[k] - r).abs().max()) <= 1e-3 * scale, k
    assert trainer.opt.step(trainer.trainable, grads)
    want = dict(toptim.leaves(from_jax_params(jax_full_step["updated"])))
    for k, t in toptim.leaves(trainer.trainable):
        sure = ref_g[k].abs() > 100 * 1e-8
        diff = (t.detach() - want[k]).abs()[sure]
        assert not diff.numel() or float(diff.max()) <= 1e-2 * LR, k


def test_full_finetune_keeps_the_codebook(tmp_path):
    """With the VQ model trainable its image tokens stay data: the encode
    runs without gradients and the codebook's gradient is zeroed, so with
    no weight decay the codebook and the encoder come out of a step bit for
    bit as they went in, while the language model moves."""
    model = tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=0,
                                   device="cpu")
    before = {k: t.clone() for k, t in toptim.leaves(model.params["gen_vision_model"])}
    wq = model.params["language_model"]["layers"]["wq"].detach().clone()
    trainer = SimPOTrainer(Config.from_nested(_full_config(
        tmp_path, freeze={"gen_vision_model": False})), model, _port_processor())
    assert trainer.trainable_keys == ["gen_vision_model", "language_model"]
    _, _, grads = trainer.loss_and_grads(*_batch())
    assert not grads["gen_vision_model"]["codebook"].any()
    trainer.opt.step(trainer.trainable, grads)
    after = dict(toptim.leaves(model.params["gen_vision_model"]))
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert not torch.equal(wq, model.params["language_model"]["layers"]["wq"])


def test_full_finetune_refuses_everything_frozen(tmp_path):
    model = tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=0,
                                   device="cpu")
    with pytest.raises(ValueError, match="everything frozen"):
        SimPOTrainer(Config.from_nested(_full_config(
            tmp_path, freeze={"language_model": True})), model, _port_processor())


def test_full_checkpoints_merge_across_packages(tmp_path):
    """A port full checkpoint (fp32; the language model and the VQ model,
    whose convolution kernels, lists and empty lists the JAX encoding keys)
    merges in ``ospo_tpu``'s ``merge_lora_checkpoint`` to the trained
    weights, and a JAX full checkpoint merges in the port's, bit for bit;
    both packages read the mode as ``full``."""
    from ospo_tpu_torch.models.weights import to_jax_layout

    cfg = jjanus.tiny_janus_config()
    params = np_janus_params(cfg, 26)
    trainer = SimPOTrainer(Config.from_nested(_full_config(
        tmp_path / "run", freeze={"gen_vision_model": False})),
        _port_model(params), _port_processor())
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # move every trained leaf off the base weights
        for _, t in toptim.leaves(trainer.trainable):
            t.add_(torch.randn(t.shape, generator=gen) * 1e-3)
    trainer.global_step = 4
    path = trainer.save()
    assert jckpt.checkpoint_mode(path) == tckpt.checkpoint_mode(path) == "full"
    merged = jckpt.merge_lora_checkpoint(
        jjanus.JanusModel(cfg, jax.tree.map(jnp.asarray, params)), path)
    for k in trainer.trainable_keys:
        _assert_trees(jax.tree.map(np.asarray, merged.params[k]),
                      to_jax_layout(trainer.trainable)[k], 0)

    rng = np.random.default_rng(27)
    moved = {k: jax.tree.map(lambda x: x + rng.standard_normal(x.shape).astype(
        np.float32) * 1e-3, params[k]) for k in ("language_model",
                                                 "gen_vision_model")}
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 3, moved,
                                  jlora.LoraConfig(), mode="full")
    model = _port_model(params)
    assert tckpt.merge_lora_checkpoint(model, jpath) is model
    for k in moved:
        _assert_trees(model.params[k], from_jax_params(moved)[k], 0)


def test_full_checkpoints_keep_bf16_bits(tmp_path):
    """bf16 leaves are written as the JAX package writes them (2-byte voids
    of the bf16 bits): a port bf16 checkpoint round-trips bit for bit (load,
    and merge into a fresh model), and a JAX bf16 checkpoint's leaves read
    back as the same bits."""
    cfg = tjanus.tiny_janus_config(dtype=torch.bfloat16)
    trainer = SimPOTrainer(Config.from_nested(_full_config(tmp_path / "run")),
                           tjanus.JanusModel.init(cfg, seed=0, device="cpu"),
                           _port_processor())
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for _, t in toptim.leaves(trainer.trainable):
            t.add_((torch.randn(t.shape, generator=gen) * 1e-2).to(t.dtype))
    trainer.global_step = 2
    path = trainer.save()
    with np.load(os.path.join(path, "lora.npz")) as f:
        assert f["language_model/layers/wq"].dtype == np.dtype("V2")
    tree, _, step, _ = tckpt.load_checkpoint(path)
    got = tree["language_model"]
    want = trainer.trainable["language_model"]
    for k, t in toptim.leaves(want):
        assert torch.equal(dict(toptim.leaves(got))[k], t.detach()), k
    fresh = tjanus.JanusModel.init(cfg, seed=5, device="cpu")
    tckpt.merge_lora_checkpoint(fresh, path)
    for k, t in toptim.leaves(want):
        g = dict(toptim.leaves(fresh.params["language_model"]))[k]
        assert g.dtype == torch.bfloat16 and torch.equal(g, t.detach()), k

    jtree = {"language_model": jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16),
        np_janus_params(jjanus.tiny_janus_config(), 28)["language_model"])}
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 1, jtree,
                                  jlora.LoraConfig(), mode="full")
    fresh = tjanus.JanusModel.init(cfg, seed=5, device="cpu")
    tckpt.merge_lora_checkpoint(fresh, jpath)
    for k, x in toptim.leaves(jtree["language_model"]):
        bits = np.asarray(x).view(np.int16)
        g = dict(toptim.leaves(fresh.params["language_model"]))[k]
        np.testing.assert_array_equal(g.view(torch.int16).numpy(), bits, err_msg=k)


def test_full_finetune_resume_is_exact(tmp_path):
    """Full mode: two steps in one run equal one step, a ``mode: full``
    checkpoint, a resume into a fresh model and the second step — the
    trained weights and the optimizer state bit for bit."""
    b1, b2 = _batch(29), _batch(30)
    conf = _full_config(tmp_path / "a", freeze={"gen_head": False})
    t1 = SimPOTrainer(Config.from_nested(conf), tjanus.JanusModel.init(
        tjanus.tiny_janus_config(), seed=0, device="cpu"), _port_processor())
    t1._step(*b1)
    t1.global_step = 1
    ckpt = t1.save()
    t1._step(*b2)
    conf["base"]["save_path"] = str(tmp_path / "b")
    t2 = SimPOTrainer(Config.from_nested(conf), tjanus.JanusModel.init(
        tjanus.tiny_janus_config(), seed=0, device="cpu"), _port_processor())
    t2.resume(ckpt)
    assert t2.global_step == 1 and t2.opt.count == 1
    t2._step(*b2)
    _assert_trees(t2.trainable, t1.trainable, 0)
    s1, s2 = t1.opt.state_dict(), t2.opt.state_dict()
    assert set(s1) == set(s2) and any(k.startswith("mu/gen_head/") for k in s1)
    for k in s1:
        torch.testing.assert_close(torch.as_tensor(s2[k]), torch.as_tensor(s1[k]),
                                   atol=0, rtol=0)


@pytest.mark.parametrize("clip,wd", [(None, 0.0), (1.0, 0.1)])
def test_optimizer_over_model_dtype_trees_matches_optax(clip, wd):
    """AdamW over a nested tree of bf16 leaves (dicts and a list), as full
    mode trains them: fp32 moments and an fp32 update rounded once into
    the parameter, no fp32 master copy; against the JAX package's
    ``build_optimizer`` (optax ``adamw(mu_dtype=float32)`` behind the fp32
    cast) for 5 steps, within one bf16 step of each parameter (optax takes
    the clipping norm in bf16, the port in fp32)."""
    rng = np.random.default_rng(31)
    shapes = {"language_model": {"layers": {"wq": (2, 3, 4)}, "embed": (5, 4)},
              "gen_vision_model": {"levels": [{"w": (3, 3)}, {"w": (2, 2)}]}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    tparams = jax.tree.map(lambda x: torch.as_tensor(x).to(torch.bfloat16), params)
    jtx = joptim.build_optimizer(init_lr=3e-2, weight_decay=wd, grad_clip=clip)
    jstate = jtx.init(jparams)
    opt = toptim.AdamW(tparams, lambda s: 3e-2, weight_decay=wd, grad_clip=clip)
    assert {k.split("/")[0] for k in opt.state_dict()} == {"count", "mini_step",
                                                           "mu", "nu"}
    assert all(t.dtype == torch.float32 for t in opt.mu.values())
    for step in range(5):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * (
            3.0 if step % 2 else 0.05)).astype(np.float32), params)
        jg = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g)
        upd, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        assert opt.step(tparams, jax.tree.map(
            lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16),
            jg))
        for k, t in toptim.leaves(tparams):
            assert t.dtype == torch.bfloat16
            ref = np.asarray(dict(toptim.leaves(jparams))[k], np.float32)
            np.testing.assert_allclose(t.float().numpy(), ref, rtol=2 ** -7,
                                       atol=1e-6, err_msg=(step, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a16_function_matches_the_plain_form(dtype):
    """``quantized_matmul`` on an input that needs a gradient runs the
    W8A16 autograd Function: its output and dX equal autograd through the
    plain form bit for bit, it keeps only the int8 payload and the scales
    for the backward (the plain form keeps an x-dtype copy of the weight),
    and the weight gets no gradient."""
    rng = np.random.default_rng(32)
    x = torch.as_tensor(rng.standard_normal((2, 5, 64), np.float32)).to(dtype)
    qw = tquant.quantize_matrix(torch.as_tensor(
        rng.standard_normal((48, 64), np.float32) * 0.02).to(dtype))
    dy = torch.as_tensor(rng.standard_normal((2, 5, 48), np.float32)).to(dtype)

    def run(fn):
        xr = x.clone().requires_grad_(True)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            y = fn(xr, qw)
        (dx,) = torch.autograd.grad(y, xr, dy)
        return y.detach(), dx, saved

    y1, dx1, kept = run(tquant.quantized_matmul)
    y2, dx2, kept_plain = run(lambda xr, w: tquant._w8a16(xr, w["q"], w["s"]))
    assert torch.equal(y1, y2) and torch.equal(dx1, dx2)
    assert {(t.dtype, tuple(t.shape)) for t in kept} == {
        (torch.int8, (48, 64)), (torch.float32, (48,))}
    assert any(t.dtype == dtype and t.numel() == 48 * 64 for t in kept_plain)
    with torch.no_grad():
        assert torch.equal(tquant.quantized_matmul(x, qw), y1)


@pytest.fixture(scope="module")
def jax_int8_step(tmp_path_factory):
    return _jax_lora_step(tmp_path_factory.mktemp("jq"), quantize_base="int8")


def test_int8_trunk_step_matches_jax(jax_int8_step, tmp_path):
    """``quantize_base: int8``: the trainer quantizes the trunk's seven
    projections before the adapters (per row, as the JAX trainer does), and
    one step on the same weights, adapters and batch matches the JAX
    trainer's with the same flag: metrics within 1e-4 relative or 1e-5
    absolute, LoRA gradients within 1e-3·max|g| per leaf."""
    model = _port_model(jax_int8_step["params"])
    trainer = SimPOTrainer(Config.from_nested(_trainer_config(
        tmp_path, "flash", quantize_base="int8")), model, _port_processor())
    layers = model.params["language_model"]["layers"]
    for name in tquant.QUANTIZABLE:
        assert set(layers[name]) == {"q", "s"} and layers[name]["q"].dtype == torch.int8
    trainer._set_trainable(jax_int8_step["lora"])
    _, metrics, grads = trainer.loss_and_grads(*_batch())
    metrics["grad_norm"] = toptim.global_norm(grads)
    for k, ref in jax_int8_step["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    _close_trees(grads, jax_int8_step["grads"], 1e-3)


def test_int8_trunk_checks_a_trunk_already_quantized(tmp_path):
    """A trunk quantized upstream must be in the mode ``quantize_base``
    asks for (the JAX trainer's ValueError); an int8 trunk with
    ``quantize_base: int8`` is kept as it is."""
    conf = Config.from_nested(_trainer_config(tmp_path, "flash",
                                              quantize_base="int8"))
    model = tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=0,
                                   quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="already int4\\*-quantized"):
        SimPOTrainer(conf, model, _port_processor())
    model = tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=0,
                                   quantize="int8", device="cpu")
    q = model.params["language_model"]["layers"]["wq"]["q"]
    SimPOTrainer(conf, model, _port_processor())
    assert model.params["language_model"]["layers"]["wq"]["q"] is q
