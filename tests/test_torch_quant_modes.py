"""The port's w8a8 and int4n weights against the JAX package on the CPU: the
exact int32 product, the quantized payloads, ``llama.forward``, the
straight-through backward, the W8A16 override, the scoring readout on a
w8a8 trunk, a training step on a w8a8 frozen trunk, and the entry points
(``get_model``, ``JanusModel.init``, the engines and the trainer in each
mode).

Both packages quantize the same numpy weights, each with its own quantize
function; the payloads are compared too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ospo_tpu.engine import scoring as jscoring
from ospo_tpu.models import llama as jllama
from ospo_tpu.ops import quant as jquant
from ospo_tpu_torch.config import Config
from ospo_tpu_torch.engine import scoring as tscoring
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models import llama as tllama
from ospo_tpu_torch.models.weights import from_jax_params
from ospo_tpu_torch.ops import quant as tquant
from ospo_tpu_torch.pipeline.model_factory import get_model
from ospo_tpu_torch.train import optim as toptim
from ospo_tpu_torch.train.trainer import SimPOTrainer
from test_torch_scoring import (PER_IMAGE, _assert_scores, _images,
                                _np_janus_params)
from test_torch_train import (_batch, _close_trees, _jax_lora_step,
                              _port_model, _port_processor, _trainer_config)

torch.set_num_threads(2)
# the first parallel torch.exp of a process can come out ~1e-4 off in the
# worker thread's share (MKL VML set-up); make that call here
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))


def _ties_only(got, ref):
    """Integer payloads equal but for rounding ties: ≤ 1 step, < 0.1%."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert diff.max(initial=0) <= 1 and (diff > 0).mean() < 1e-3


# ---------------------------------------------------------------------------
# w8a8: the product, the backward, the override
# ---------------------------------------------------------------------------


def test_w8a8_int32_product_is_exact_and_equal_to_jax():
    """Payload and activation quantization equal JAX's (tie rule), the
    int8 × int8 product equals JAX's int32 einsum exactly (K = 256: sums
    beyond int16), and the scaled fp32 result is within 1e-5."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((24, 256)).astype(np.float32)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    jqw = jquant.quantize_matrix_w8a8(jnp.asarray(w))
    tqw = tquant.quantize_matrix_w8a8(torch.from_numpy(w))
    assert set(tqw) == {"q", "sa"} and tqw["q"].dtype == torch.int8
    _ties_only(tqw["q"].numpy(), jqw["q"])
    np.testing.assert_array_equal(tqw["sa"].numpy(), np.asarray(jqw["sa"]))
    jxq, jsx = jquant.quantize_activations_int8(jnp.asarray(x))
    txq, tsx = tquant.quantize_activations_int8(torch.from_numpy(x))
    _ties_only(txq.numpy(), jxq)
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    ref = np.asarray(jnp.einsum("btd,fd->btf", jxq, jqw["q"],
                                preferred_element_type=jnp.int32))
    got = tquant.int8_matmul(torch.from_numpy(np.asarray(jxq)).reshape(6, 256),
                             torch.from_numpy(np.asarray(jqw["q"])))
    assert got.dtype == torch.int32 and np.abs(ref).max() > 1 << 15
    np.testing.assert_array_equal(got.numpy().reshape(ref.shape), ref)
    y = tquant.quantized_matmul_w8a8(torch.from_numpy(x), tqw)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jquant.quantized_matmul_w8a8(jnp.asarray(x), jqw)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        tquant.dequantize_matrix_w8a8(tqw, torch.float32).numpy(),
        np.asarray(jquant.dequantize_matrix_w8a8(jqw, jnp.float32)))


def test_w8a8_ste_gradient_matches_jax():
    """``_W8A8``'s backward against the JAX ``custom_vjp`` (bf16 x and
    cotangent): within 1e-3·max|g|, non-zero, and no gradient for the
    scales (the int8 payload cannot take one)."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((24, 16)) * 0.5).astype(np.float32)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    g = rng.standard_normal((2, 5, 24)).astype(np.float32)
    jqw = jquant.quantize_matrix_w8a8(jnp.asarray(w))
    jy, vjp = jax.vjp(lambda x_: jquant.quantized_matmul_w8a8(x_, jqw),
                      jnp.asarray(x, jnp.bfloat16))
    (jdx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    tqw = {"q": torch.from_numpy(np.asarray(jqw["q"])),
           "sa": torch.from_numpy(np.asarray(jqw["sa"])).requires_grad_(True)}
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    ty = tquant.quantized_matmul_w8a8(tx, tqw)
    ty.backward(torch.from_numpy(g).bfloat16())
    assert ty.dtype == tx.grad.dtype == torch.bfloat16 and tqw["sa"].grad is None
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(jy, np.float32), atol=1e-2, rtol=1e-2)
    ref = np.asarray(jdx, np.float32)
    got = tx.grad.float().numpy()
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_w8a16_override_routes_weight_only():
    """Inside ``w8a16_override()`` a w8a8 weight runs the weight-only
    product (equal to int8 W8A16 on the same payload, and to JAX's
    override within 1e-5); outside it the int8 × int8 one; the flag is
    restored after an exception."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((24, 32)).astype(np.float32)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    qw = tquant.quantize_matrix_w8a8(torch.from_numpy(w))
    tx = torch.from_numpy(x)
    assert not tquant.w8a16_active()
    with tquant.w8a16_override():
        assert tquant.w8a16_active()
        inside = tllama.linear(tx, qw)
    assert torch.equal(inside, tquant.quantized_matmul(
        tx, {"q": qw["q"], "s": qw["sa"]}))
    assert torch.equal(tllama.linear(tx, qw), tquant.quantized_matmul_w8a8(tx, qw))
    assert not torch.equal(inside, tllama.linear(tx, qw))
    jqw = {"q": jnp.asarray(qw["q"].numpy()), "sa": jnp.asarray(qw["sa"].numpy())}
    with jquant.w8a16_override():
        ref = jllama._maybe_lora(jnp.asarray(x), jqw, None, "q_proj", 1.0)
    np.testing.assert_allclose(inside.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(RuntimeError):
        with tquant.w8a16_override():
            raise RuntimeError
    assert not tquant.w8a16_active()


# ---------------------------------------------------------------------------
# int4n
# ---------------------------------------------------------------------------


def test_int4n_values_equal_jax_int4():
    """The port stores int4n packed as ``{"q4", "s"}``; its values are the
    JAX package's ``jnp.int4`` ones (bf16 weights), scales equal."""
    w = np.random.default_rng(3).standard_normal((2, 8, 16)).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16)
    ref = jquant.quantize_matrix_int4_native(jw)
    # int4n is int4's quantizer: the same payload, the same kernel path
    assert tquant.quant_fn("int4n") is tquant.quant_fn("int4")
    got = tquant.quant_fn("int4n")(torch.from_numpy(w).bfloat16())
    assert set(got) == {"q4", "s"} and got["q4"].shape == (2, 4, 16)
    lo, hi = tquant.unpack_int4_halves(got["q4"])
    _ties_only(torch.cat([lo, hi], dim=-2).numpy(), np.asarray(ref["q"], np.int8))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["w8a8", "int4n"])
def test_llama_forward_quant_modes_match_jax(mode, dtype):
    """Each package quantizes the same weights in ``mode``; a prefill into
    an int8 shbd cache and one cached T = 1 step (int4n: the decode
    matmul's plain version) within 1e-5 of JAX in fp32, 2e-2 in bf16."""
    jdt = getattr(jnp, dtype)
    cfg_j = jllama.tiny_config(dtype=jdt)
    cfg_t = tllama.tiny_config(dtype=getattr(torch, dtype))
    jp = jllama.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = from_jax_params({"language_model": jax.tree.map(np.asarray, jp)})[
        "language_model"]
    tquant.quantize_layers(tp["layers"], mode)
    jq = jquant.quantize_llama_params(jp, mode)
    tol = 1e-5 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(4)
    B, T, S = 2, 8, 12
    x = rng.standard_normal((B, T, cfg_j.hidden_size)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jc = jllama.init_kv_cache(cfg_j, B, S, quantized="int8", layout="shbd")
    tc = tllama.init_kv_cache(cfg_t, B, S, quantized="int8")
    jh, jc = jllama.forward(jq, cfg_j, jnp.asarray(x, jdt), jnp.asarray(mask),
                            jnp.asarray(pos), kv_cache=jc, self_attn=True,
                            cache_layout="shbd")
    th, tc = tllama.forward(tp, cfg_t, torch.from_numpy(x), torch.from_numpy(mask),
                            torch.from_numpy(pos), kv_cache=tc, self_attn=True)
    np.testing.assert_allclose(th.float().numpy(), np.asarray(jh, np.float32),
                               atol=tol, rtol=tol)
    xd = rng.standard_normal((B, 1, cfg_j.hidden_size)).astype(np.float32)
    window = np.ones((B, S), np.int32)
    pd = np.full((B, 1), T, np.int32)
    jh2, _ = jllama.forward(jq, cfg_j, jnp.asarray(xd, jdt), jnp.asarray(window),
                            jnp.asarray(pd), kv_cache=jc, cache_layout="shbd")
    th2, _ = tllama.forward(tp, cfg_t, torch.from_numpy(xd),
                            torch.from_numpy(window), torch.from_numpy(pd),
                            kv_cache=tc)
    np.testing.assert_allclose(th2.float().numpy(), np.asarray(jh2, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# scoring on a w8a8 trunk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def w8a8_pair():
    """test_torch_scoring's tiny Janus and processors, the trunk quantized
    to w8a8 by each package."""
    from ospo_tpu.image_processing import ImageProcessor as JImageProcessor
    from ospo_tpu.models import janus as jjanus
    from ospo_tpu.processing import Processor as JProcessor
    from ospo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
    from ospo_tpu_torch.image_processing import ImageProcessor
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import ByteTokenizer

    cfg = jjanus.tiny_janus_config()
    params = _np_janus_params(cfg, 0)
    tparams = from_jax_params(params)
    tquant.quantize_layers(tparams["language_model"]["layers"], "w8a8")
    jlm = dict(params["language_model"])
    jlm["layers"] = {n: (jquant.quantize_matrix_w8a8(w) if n in jquant.QUANTIZABLE
                         else w) for n, w in jlm["layers"].items()}
    jmodel = jjanus.JanusModel(cfg, {**params, "language_model": jlm})
    tmodel = tjanus.JanusModel(tjanus.tiny_janus_config(), tparams,
                               torch.device("cpu"))
    jproc = JProcessor(JByteTokenizer(512), JImageProcessor(image_size=32),
                       num_image_tokens=cfg.num_image_tokens)
    tproc = Processor(ByteTokenizer(512), ImageProcessor(image_size=32),
                      num_image_tokens=4)
    return jmodel, tmodel, jproc, tproc


@pytest.mark.parametrize("readout_w8a16", [False, True])
def test_scoring_on_w8a8_trunk_matches_jax(w8a8_pair, readout_w8a16):
    """The pre-image program on a w8a8 trunk, with the readout's question
    suffixes in w8a8 or under the W8A16 override (the attribute JAX reads
    from OSPO_SCORE_READOUT): p's within test_torch_scoring's bounds."""
    jmodel, tmodel, jproc, tproc = w8a8_pair
    je = jscoring.ScoringEngine(jmodel, jproc)
    te = tscoring.ScoringEngine(tmodel, tproc)
    assert te.readout_w8a16 is False
    je.readout_w8a16 = te.readout_w8a16 = readout_w8a16
    imgs = _images(3, 12)
    ref = je.score_images_multi([Image.fromarray(i) for i in imgs], PER_IMAGE)
    out = te.score_images_multi(imgs, PER_IMAGE)
    _assert_scores(out, ref)
    if readout_w8a16:   # the override changed the suffix products
        te.readout_w8a16 = False
        off = te.score_images_multi(imgs, PER_IMAGE)
        assert any(a["p_yes"] != b["p_yes"]
                   for ra, rb in zip(out, off)
                   for a, b in zip(ra["answer_metadata"], rb["answer_metadata"]))


# ---------------------------------------------------------------------------
# step 5 on a w8a8 frozen trunk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_w8a8_step(tmp_path_factory):
    return _jax_lora_step(tmp_path_factory.mktemp("jw"), quantize_base="w8a8")


def test_w8a8_trunk_step_matches_jax(jax_w8a8_step, tmp_path):
    """``quantize_base: w8a8``: the trainer quantizes the seven projections
    to ``{"q", "sa"}`` before the adapters, and one step (the w8a8 forward,
    the straight-through backward) matches the JAX trainer's: metrics
    within 1e-4 relative or 1e-5 absolute, as the int8 trunk's test holds
    them; LoRA gradients within 2^-8·max|g| per leaf, one bf16 step.  Both
    backwards round ``g · sa`` and each product to bf16 (the JAX
    ``custom_vjp``), so float-order noise upstream flips a few of those
    roundings: the worst leaf reads 1.7e-3·max|g| here, where the int8
    trunk's fp32 backward stays under 2e-6
    (``test_w8a8_trunk_step_gap_is_the_roundings`` takes the sources off
    one at a time).  A backward without ``sa`` reads 0.38·max|g|, one that
    rounds only the product and not ``g · sa`` 4.0e-3: both fail."""
    model = _port_model(jax_w8a8_step["params"])
    trainer = SimPOTrainer(Config.from_nested(_trainer_config(
        tmp_path, "flash", quantize_base="w8a8")), model, _port_processor())
    layers = model.params["language_model"]["layers"]
    for name in tquant.QUANTIZABLE:
        assert set(layers[name]) == {"q", "sa"}
    trainer._set_trainable(jax_w8a8_step["lora"])
    _, metrics, grads = trainer.loss_and_grads(*_batch())
    metrics["grad_norm"] = toptim.global_norm(grads)
    for k, ref in jax_w8a8_step["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    _close_trees(grads, jax_w8a8_step["grads"], 2 ** -8)


def _fp32_ste_jax():
    """JAX's w8a8 product with the straight-through backward in fp32: no
    bf16 rounding of ``g · sa`` or of the product."""
    @jax.custom_vjp
    def matmul(x, q, sa):
        return jquant._w8a8_raw(x, q, sa)

    def fwd(x, q, sa):
        return jquant._w8a8_raw(x, q, sa), (q, sa)

    def bwd(res, g):
        q, sa = res
        dx = jnp.einsum("btf,fd->btd", g.astype(jnp.float32) * sa,
                        q.astype(jnp.float32))
        return (dx.astype(g.dtype), np.zeros(q.shape, jax.dtypes.float0),
                jnp.zeros_like(sa))

    matmul.defvjp(fwd, bwd)
    return matmul


class _Fp32Ste(torch.autograd.Function):
    """The port's counterpart of :func:`_fp32_ste_jax`."""

    @staticmethod
    def forward(ctx, x, q, sa, amax_reduce=None):
        ctx.save_for_backward(q, sa)
        return tquant._w8a8_raw(x, q, sa, amax_reduce)

    @staticmethod
    def backward(ctx, g):
        q, sa = ctx.saved_tensors
        return ((g.float() * sa) @ q.float()).to(g.dtype), None, None, None


def _dequantized_jax(x, q, sa):
    w = q.astype(jnp.float32) * sa[..., None]
    return jnp.einsum("btd,fd->btf", x.astype(jnp.float32), w).astype(x.dtype)


def _dequantized_torch(x, q, sa, amax_reduce=None):
    return (x.float() @ (q.float() * sa[:, None]).T).to(x.dtype)


@pytest.mark.parametrize("variant,rel", [("fp32_backward", 1e-3),
                                         ("dequantized", 1e-5)])
def test_w8a8_trunk_step_gap_is_the_roundings(tmp_path, monkeypatch, variant,
                                              rel):
    """Where the w8a8 step's gradient gap comes from, by switching its
    sources off in both packages at once.  ``fp32_backward``: both
    straight-through backwards in fp32 (no bf16 rounding of ``g · sa`` or
    of the product), activations still quantized: the leaves agree within
    the int8 trunk's 1e-3·max|g| (3.7e-4 here, against 1.7e-3 with the
    bf16 backwards; JAX's own bf16 backward sits 4.3e-3·max|g| from its
    fp32 one).  ``dequantized``: both forwards the fp32 product
    ``x @ (q · sa)ᵀ`` as well: within 1e-5 (2.2e-6 here), so what the
    fp32 backward leaves is the per-token activation rounding, whose
    codes float-order noise flips by one step."""
    jstep = _fp32_ste_jax() if variant == "fp32_backward" else _dequantized_jax
    with monkeypatch.context() as m:
        m.setattr(jquant, "_w8a8_matmul", jstep)
        ref = _jax_lora_step(tmp_path / "j", quantize_base="w8a8")
    jax.clear_caches()
    monkeypatch.setattr(tquant, "_W8A8", _Fp32Ste)
    if variant == "dequantized":
        monkeypatch.setattr(tquant, "_w8a8_raw", _dequantized_torch)
    model = _port_model(ref["params"])
    trainer = SimPOTrainer(Config.from_nested(_trainer_config(
        tmp_path, "flash", quantize_base="w8a8")), model, _port_processor())
    trainer._set_trainable(ref["lora"])
    _, _, grads = trainer.loss_and_grads(*_batch())
    _close_trees(grads, ref["grads"], rel)


@pytest.mark.parametrize("built,asked", [("int8", "w8a8"), ("w8a8", "int8")])
def test_trunk_mode_mismatch_is_refused(tmp_path, built, asked):
    """A trunk quantized upstream in another mode than ``quantize_base``
    asks for is the JAX trainer's ValueError (``have = "w8a8" if "sa" in
    wq``)."""
    model = tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=0,
                                   quantize=built, device="cpu")
    conf = Config.from_nested(_trainer_config(tmp_path, "flash",
                                              quantize_base=asked))
    with pytest.raises(ValueError, match=f"already {built}-quantized"):
        SimPOTrainer(conf, model, _port_processor())


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["w8a8", "int4n"])
def test_get_model_and_init_serve_the_modes(mode, capsys):
    """``get_model`` and ``JanusModel.init`` quantize the trunk in the
    mode (the same draws as the unquantized init), and step 3's engine
    decodes on it."""
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine
    from ospo_tpu_torch.processing import t2i_prompt

    model, _, proc = get_model({"model_preset": "tiny", "device": "cpu",
                                "quantize": mode, "seed": 3})
    kind = "W8A8" if mode == "w8a8" else "W4A16"
    assert f"# Quantizing language-model weights to {mode} ({kind})." in \
        capsys.readouterr().out
    plain = tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=3,
                                   device="cpu")
    qfn = tquant.quant_fn(mode)
    for name in tquant.QUANTIZABLE:
        got = model.params["language_model"]["layers"][name]
        ref = qfn(plain.params["language_model"]["layers"][name])
        assert set(got) == ({"q", "sa"} if mode == "w8a8" else {"q4", "s"})
        for k in ref:
            torch.testing.assert_close(got[k], ref[k], atol=0, rtol=0)
    engine = ImageGenEngine(model, proc, image_token_num=8, img_size=16,
                            patch_size=2)
    toks = engine.generate_tokens([t2i_prompt(proc, "a red cube")], seed=0)
    assert toks.shape == (1, 8) and int(toks.max()) < model.cfg.image_token_size


def _recording_caches(monkeypatch):
    """Every KV cache the engines make from here on: (its ``quantized``
    argument, the cache)."""
    made, init = [], tjanus.init_kv_cache

    def record(*args, **kwargs):
        made.append((kwargs.get("quantized", False), init(*args, **kwargs)))
        return made[-1][1]

    monkeypatch.setattr(tjanus, "init_kv_cache", record)
    return made


def _assert_int4_cache(made):
    """At least one cache is the int4 one: int8 bytes of two heads each,
    beside one fp32 scale a head and position."""
    int4 = [kv for quantized, kv in made if quantized == "int4"]
    assert int4
    for kv in int4:
        assert kv["k"].dtype == kv["v"].dtype == torch.int8
        assert kv["k"].numel() * 2 == kv["k_s"].numel() * kv["k"].shape[-1]


def _assert_trunk(model, payload):
    layers = model.params["language_model"]["layers"]
    for name in tquant.QUANTIZABLE:
        assert set(layers[name]) == payload, name


def _step3_int4n_int4_kv(model_config, tmp_path, monkeypatch):
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine
    from ospo_tpu_torch.processing import t2i_prompt

    model, _, proc = get_model({**model_config, "quantize": "int4n"})
    made = _recording_caches(monkeypatch)
    engine = ImageGenEngine(model, proc, image_token_num=16,
                            img_size=model.cfg.gen_image_size,
                            patch_size=model.cfg.vq.downsample_factor,
                            kv_quant="int4")
    prompts = [t2i_prompt(proc, p) for p in ("a red cube", "two blue spheres")]
    toks = engine.generate_tokens(prompts, seed=0)
    assert toks.shape == (2, 16) and int(toks.max()) < model.cfg.image_token_size
    _assert_trunk(model, {"q4", "s"})
    _assert_int4_cache(made)


def _text_w8a8_int4_kv(model_config, tmp_path, monkeypatch):
    from ospo_tpu_torch.engine.text_engine import TextGenEngine

    model, _, proc = get_model({**model_config, "quantize": "w8a8"})
    made = _recording_caches(monkeypatch)
    engine = TextGenEngine(model, proc, max_new_tokens=16, kv_quant="int4")
    ids = engine.generate_ids(["A" * 40, "A" * 24 + "B" * 9, "C" * 7], seed=0)
    assert ids.shape == (3, 16)
    _assert_trunk(model, {"q", "sa"})
    _assert_int4_cache(made)


def _score_w8a8(model_config, tmp_path, monkeypatch):
    model, _, proc = get_model({**model_config, "quantize": "w8a8"})
    engine = tscoring.ScoringEngine(model, proc)
    out = engine.score_images_multi(_images(3, 4, model.cfg.image_size), PER_IMAGE)
    assert len(out) == 3
    for got, questions in zip(out, PER_IMAGE):
        assert len(got["answer_metadata"]) == len(questions)
        assert np.isfinite([got["local_score"], got["global_score"]]).all()
    _assert_trunk(model, {"q", "sa"})


def _train_w8a8_base(model_config, tmp_path, monkeypatch):
    from ospo_tpu_torch.pipeline.datasets import PreferenceDataset
    from ospo_tpu_torch.utils.png import write_png

    model, _, proc = get_model(model_config)
    records = []
    for i, (chosen, rejected) in enumerate(zip(*[iter(_images(4, 5))] * 2)):
        paths = [str(tmp_path / f"{i}_{side}.png") for side in ("c", "r")]
        write_png(paths[0], chosen)
        write_png(paths[1], rejected)
        records.append({"item_id": str(i), "prompt": f"a photo of object {i}",
                        "chosen": paths[0], "rejected": paths[1]})
    (tmp_path / "train.json").write_text(json.dumps(records))
    trainer = SimPOTrainer(Config.from_nested(_trainer_config(
        tmp_path / "ckpt", "flash", quantize_base="w8a8",
        max_training_steps=1)), model, proc)
    _assert_trunk(model, {"q", "sa"})
    frozen = {n: model.params["language_model"]["layers"][n]["q"].clone()
              for n in tquant.QUANTIZABLE}
    trainer.fit(PreferenceDataset(seed=0, data_path=str(tmp_path / "train.json"),
                                  processor=proc), batch_size=2)
    assert trainer.global_step == 1 and np.isfinite(float(trainer.logged[-1]["loss"]))
    _assert_trunk(model, {"q", "sa"})
    for name, q in frozen.items():
        assert torch.equal(model.params["language_model"]["layers"][name]["q"], q)


@pytest.mark.parametrize("case", [_step3_int4n_int4_kv, _text_w8a8_int4_kv,
                                  _score_w8a8, _train_w8a8_base],
                         ids=["step3-int4n-int4kv", "text-w8a8-int4kv",
                              "score-w8a8", "train-w8a8-base"])
def test_engines_take_the_modes(case, tmp_path, monkeypatch):
    """``quantize: w8a8 | int4n`` through ``get_model`` and ``kv_quant:
    int4`` reach the engines, and ``quantize_base: w8a8`` the trainer's
    ``fit``: the trunk holds the mode's payload, the decode engines make
    the int4 head-pair cache, and each returns its output in full."""
    case({"model_preset": "tiny", "device": "cpu", "seed": 0}, tmp_path,
         monkeypatch)
