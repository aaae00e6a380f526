"""The port's int4 weights (``ops/quant.py`` int4 subset, ``ops/int4_matmul.py``)
and step 3 with ``quantize: int4 | int4g`` against the JAX package on the CPU.

Inputs are made from a seed with numpy.  The JAX package's Pallas decode
matmul runs in interpret mode, as ``tests/test_int4_matmul.py`` runs it; the
port runs its kernels' plain versions (CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ospo_tpu.models import janus as jjanus
from ospo_tpu.models import llama as jllama
from ospo_tpu.ops import int4_matmul as jint4
from ospo_tpu.ops import quant as jquant
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models import llama as tllama
from ospo_tpu_torch.models.weights import from_jax_params
from ospo_tpu_torch.ops import int4_matmul as tint4
from ospo_tpu_torch.ops import quant as tquant
from ospo_tpu_torch.utils.profiling import kernel_launches
import int4_mma_reference
from test_torch_models import np_janus_params

torch.set_num_threads(2)
# torch's CPU exp (MKL's vector math) sets itself up on its first call; in
# some processes the worker thread's share of that first parallel call came
# out ~1e-4 off, and every later call was exact: make that call here, once on
# this thread and once spread over both threads
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))

QUANT = {"int4": (jquant.quantize_matrix_int4, tquant.quantize_matrix_int4),
         "int4g": (jquant.quantize_matrix_int4_group,
                   tquant.quantize_matrix_int4_group)}


def _weights(seed, f, d, m):
    """W [F, D] ~ N(0, 0.05²) with three outlier columns (x8), so row and
    group scales differ; x [M, 1, D] ~ N(0, 0.5²)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((f, d)).astype(np.float32) * 0.05
    w[:, :3] *= 8.0
    x = (rng.standard_normal((m, 1, d)) * 0.5).astype(np.float32)
    return w, x


def _jt(a, dtype):
    """numpy fp32 → (jax array, torch tensor) in ``dtype`` (fp32 | bf16),
    both rounded to nearest even."""
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t)


def _torch_qw(jqw):
    return {k: torch.from_numpy(np.array(v)) for k, v in jqw.items()}


@pytest.mark.parametrize("f,d", [(256, 256), (32, 64)])  # 64: group clamps to D
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_quantize_int4_bit_equal(mode, dtype, f, d):
    """Packed payload bit-equal, scales equal, for the same matrix."""
    w, _ = _weights(0, f, d, 1)
    jw, tw = _jt(w, dtype)
    jfn, tfn = QUANT[mode]
    ref, got = jfn(jw), tfn(tw)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    if mode == "int4g":
        assert got["gs"].shape[-1] == d // min(128, d)


def test_unpack_and_pack_over_every_byte():
    """Unpack bit-equal to ``unpack_int4_halves`` over all 256 byte values;
    packing bit-equal to the reference's wrapping int8 shift over every
    (low, high) pair of int4 values."""
    b = np.arange(-128, 128, dtype=np.int8)[None, :]
    jlow, jhigh = jquant.unpack_int4_halves(jnp.asarray(b))
    tlow, thigh = tquant.unpack_int4_halves(torch.from_numpy(b))
    assert tlow.dtype == thigh.dtype == torch.int8
    np.testing.assert_array_equal(tlow.numpy(), np.asarray(jlow))
    np.testing.assert_array_equal(thigh.numpy(), np.asarray(jhigh))

    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    q = np.stack([lo.ravel(), hi.ravel()]).astype(np.int8)      # [F=2, 256]
    ref = jnp.bitwise_or(jnp.bitwise_and(jnp.asarray(q[:1]), jnp.int8(0x0F)),
                         jnp.left_shift(jnp.asarray(q[1:]), 4)).astype(jnp.int8)
    got = tquant._pack_halves(torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = torch.cat(tquant.unpack_int4_halves(got))
    np.testing.assert_array_equal(back.numpy(), q)


@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_dequantize_matches_jax(mode):
    w, _ = _weights(1, 64, 256, 1)
    jqw = QUANT[mode][0](jnp.asarray(w))
    jde = (jquant.dequantize_matrix_int4_group if mode == "int4g"
           else jquant.dequantize_matrix_int4)(jqw, jnp.float32)
    tde = (tquant.dequantize_matrix_int4_group if mode == "int4g"
           else tquant.dequantize_matrix_int4)(_torch_qw(jqw), torch.float32)
    np.testing.assert_array_equal(tde.numpy(), np.asarray(jde))


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("f,d", [(256, 256), (512, 384)])
@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_plain_decode_matmul_matches_pallas_and_xla(mode, f, d, m):
    """bf16 x: the plain version against the Pallas kernel (interpret mode),
    which computes the same function — within one bf16 step (2^-7 |ref|,
    1e-3 absolute; the fp32 sums run in another order) — and against the
    XLA form at ``tests/test_int4_matmul.py``'s tolerances (2e-2 row, 3e-2
    group: the group form scales fp32 partial sums instead)."""
    w, x = _weights(2, f, d, m)
    jfn, _ = QUANT[mode]
    jqw = jfn(jnp.asarray(w, jnp.bfloat16))
    jx, tx = _jt(x, "bf16")
    got = tint4.int4_matmul_decode_plain(tx, _torch_qw(jqw))
    pallas = jint4.int4_matmul_decode(jx, jqw, interpret=True)
    xla = (jquant.quantized_matmul_int4_group if mode == "int4g"
           else jquant.quantized_matmul_int4)(jx, jqw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, 1, f)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=2 ** -7, atol=1e-3)
    np.testing.assert_allclose(_np(got), _np(xla), rtol=0,
                               atol=3e-2 if mode == "int4g" else 2e-2)


@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_plain_decode_matmul_fp32_matches_pallas(mode):
    """fp32 x: every product is exact, so the two agree to fp32 summation
    order (1e-5)."""
    w, x = _weights(3, 256, 384, 8)
    jqw = QUANT[mode][0](jnp.asarray(w))
    got = tint4.int4_matmul_decode_plain(torch.from_numpy(x), _torch_qw(jqw))
    ref = jint4.int4_matmul_decode(jnp.asarray(x), jqw, interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_prefill_forms_match_xla(mode, dtype):
    """T > 1: the row form is the reference's two-plane product (fp32: 1e-5;
    bf16: 2e-2 as the decode tests); the group form dequantizes the matrix
    to x's dtype and runs one product, where the reference scales fp32
    per-group partial sums (fp32: 1e-5; bf16: 3e-2)."""
    w, _ = _weights(4, 128, 256, 1)
    x = (np.random.default_rng(5).standard_normal((3, 7, 256)) * 0.5
         ).astype(np.float32)
    jw, _ = _jt(w, dtype)
    jqw = QUANT[mode][0](jw)
    jx, tx = _jt(x, dtype)
    if mode == "int4g":
        ref = jquant.quantized_matmul_int4_group(jx, jqw)
        got = tquant.quantized_matmul_int4_group(tx, _torch_qw(jqw))
    else:
        ref = jquant.quantized_matmul_int4(jx, jqw)
        got = tquant.quantized_matmul_int4(tx, _torch_qw(jqw))
    assert got.dtype == tx.dtype and tuple(got.shape) == (3, 7, 128)
    atol = 1e-5 if dtype == "fp32" else (3e-2 if mode == "int4g" else 2e-2)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=atol)


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    w, x = _weights(6, 64, 128, 3)
    for mode in ("int4", "int4g"):
        qw = QUANT[mode][1](torch.from_numpy(w))
        n0 = kernel_launches()
        got = tint4.int4_matmul_decode(torch.from_numpy(x), qw)
        ref = tint4.int4_matmul_decode_plain(torch.from_numpy(x), qw)
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
        assert kernel_launches() == n0


SPLIT_SHAPES = ((48, 2048, 4096), (48, 5504, 4096), (48, 2048, 11008),
                (2, 37, 80), (256, 8, 16), (40, 1000, 4096), (1, 1, 16),
                (130, 48, 1040), (48, 40000, 4096))


def test_splits_cover_d_and_fill_the_card():
    """The wrapper's split of D for the fp32 body: multiples of the kernel's
    stage, every split non-empty, together exactly D; at the 7B shapes at
    least two blocks per SM."""
    for m, f2, d in SPLIT_SHAPES:
        per, n = tint4._splits(m, f2, d)
        assert per % tint4.K_STEP == 0 and (n - 1) * per < d <= n * per
        tiles = -(-f2 // tint4.TILE_ROWS) * -(-m // tint4.TILE_M)
        if f2 >= 2048:
            assert tiles * n >= tint4.TARGET_BLOCKS


def test_cluster_plan_covers_d_in_one_wave():
    """The split of D for the bf16 body, on cards holding 264 // n or (as
    the H100 measured) fewer clusters of n blocks: clusters of 1 to 8
    blocks whose chunk ranges are non-empty and cover D's 128-column chunks
    exactly, in rank order; the largest split whose clusters all fit at
    once; the tiles cover F/2 and M; at the 7B shapes at least one block per
    SM (132)."""
    measured = {1: 264, 2: 132, 4: 62, 8: 30}    # cudaOccupancyMaxActiveClusters
    cards = (lambda n: 264 // n, lambda n: measured.get(n, 264 // n - 2))
    for m, f2, d in SPLIT_SHAPES:
        tiles = -(-f2 // tint4.TILE_ROWS) * -(-m // tint4.TILE_M)
        assert tiles * tint4.TILE_ROWS >= f2 and -(-m // tint4.TILE_M) * \
            tint4.TILE_M >= m
        for capacity in cards:
            n = tint4._clusters(m, f2, d, capacity)
            chunks = -(-d // tint4.CHUNK)
            assert 1 <= n <= min(8, chunks)
            ranges = [list(int4_mma_reference.cluster_chunks(d, n, r))
                      for r in range(n)]
            assert all(ranges) and sum(ranges, []) == list(range(chunks))
            fits = [k for k in range(1, min(8, chunks) + 1) if tiles <= capacity(k)]
            assert n == (max(fits) if fits else 1)
            if 2048 <= f2 <= 5504:
                assert tiles * n >= 132


def test_mma_decode_is_unpack_over_every_byte():
    """The bf16 body's decode (byte permute, lop3 into 128.0's mantissa, less
    136) over all 256 byte values, in every position of a word: both planes
    bit for bit the values of ``unpack_int4_halves``."""
    b = np.arange(-128, 128, dtype=np.int8)
    q4 = torch.from_numpy(np.stack([np.roll(b, i) for i in range(4)]))
    low, high = int4_mma_reference.decode_planes(q4)
    ref_low, ref_high = tquant.unpack_int4_halves(q4)
    assert low.dtype == high.dtype == torch.bfloat16
    torch.testing.assert_close(low, ref_low.to(torch.bfloat16), atol=0, rtol=0)
    torch.testing.assert_close(high, ref_high.to(torch.bfloat16), atol=0, rtol=0)


@pytest.mark.parametrize("d,groups", [(384, 3), (256, 16), (112, 1)])
def test_mma_group_weights_bit_for_bit(d, groups):
    """w = r(nib · r(gs)) from the kernel's decode and one bf16 multiply: bit
    for bit the plain version's weights, for both planes, with scales from
    tiny to large."""
    rng = np.random.default_rng(7)
    q4 = torch.from_numpy(rng.integers(-128, 128, (96, d), dtype=np.int8))
    gs = torch.from_numpy((rng.standard_normal((192, groups)) * 10.0 **
                           rng.integers(-6, 3, (192, groups))).astype(np.float32))
    low, high = int4_mma_reference.decode_planes(q4)
    ref_low, ref_high = tquant.unpack_int4_halves(q4)
    for got_nib, ref_nib, rows in ((low, ref_low, gs[:96]),
                                   (high, ref_high, gs[96:])):
        got = int4_mma_reference.plane_weights(got_nib, rows)
        ref = tint4.group_weights(ref_nib, rows, torch.bfloat16)
        assert got.dtype == ref.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(torch.int16).numpy())


def test_mma_k_order_is_each_lanes_own_bytes():
    """The permuted k of a 128-column chunk takes every column once; in half
    h, lane tig reads only columns 64 h + 16 tig .. 64 h + 16 tig + 15 (its
    16 contiguous bytes of q4 and 32 of each x row), step s only 4s .. 4s + 3
    of them, in order within each register pair."""
    order = int4_mma_reference.k_order()
    assert sorted(order.ravel().tolist()) == list(range(128))
    for h in range(2):
        for s in range(4):
            for tig in range(4):
                slots = [2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9]
                assert order[h, s, slots].tolist() == [
                    64 * h + 16 * tig + 4 * s + e for e in range(4)]


@pytest.mark.parametrize("m", [1, 48, 130])
@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_mma_sum_order_matches_plain_and_pallas(mode, m):
    """The bf16 body's function in its own order of fp32 sums (permuted k,
    k16 steps, chunks, the two halves of the chunks' columns, a cluster's
    blocks in rank order; D = 1152 is nine
    chunks, split 1, 2, 3, 5 and 8 ways) against the plain version and the
    Pallas kernel (interpret mode): within one bf16 step (2^-7 |ref|, 2^-6
    for the row form, rounded before and after its scale) + 1e-3 max|ref|;
    the fp32 sums within 1e-5 of the plain version's."""
    w, x = _weights(8, 256, 1152, m)
    jqw = QUANT[mode][0](jnp.asarray(w, jnp.bfloat16))
    jx, tx = _jt(x, "bf16")
    qw = _torch_qw(jqw)
    plain = tint4.int4_matmul_decode_plain(tx, qw)
    pallas = torch.from_numpy(_np(jint4.int4_matmul_decode(jx, jqw,
                                                           interpret=True)))
    rtol = 2 ** -6 if mode == "int4" else 2 ** -7
    for nsplit in (None, 1, 2, 3, 5, 8):
        got, acc = int4_mma_reference.mma_decode_matmul(tx, qw, nsplit,
                                                        return_acc=True)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, 1, 256)
        for ref in (plain.float(), pallas):
            top = float(ref.abs().max())
            torch.testing.assert_close(got.float(), ref, atol=1e-3 * top,
                                       rtol=rtol)
        low, high = tquant.unpack_int4_halves(qw["q4"])
        if mode == "int4g":
            wf = torch.cat([tint4.group_weights(low, qw["gs"][:128], torch.bfloat16),
                            tint4.group_weights(high, qw["gs"][128:], torch.bfloat16)])
        else:
            wf = torch.cat([low, high])
        ref_acc = tx[:, 0].float() @ wf.float().T
        top = float(ref_acc.abs().max())
        torch.testing.assert_close(acc, ref_acc, atol=1e-5 * top, rtol=1e-5)


def _prompt_mask(b, t, pad):
    mask = np.ones((b, t), np.int32)
    for i, p in enumerate(pad):
        mask[i, :p] = 0
    return mask


@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_llama_prefill_and_decode_step_int4(mode):
    """``tllama.forward`` prefill and one cached decode step with int4 (row)
    and int4g weights, against ``jllama.forward`` (its XLA int4 forms), the
    weights quantized by the JAX package and carried across by
    ``from_jax_params``; tiny fp32 config, 1e-4 as in
    ``test_llama_prefill_and_decode_step``.  The port quantizes the same
    fp32 weights layer by layer to the same leaves as the stacked JAX
    quantization."""
    cfg_j, cfg_t = jllama.tiny_config(), tllama.tiny_config()
    jp = jllama.init_params(cfg_j, jax.random.PRNGKey(0))
    fp32_layers = {n: torch.from_numpy(np.array(jp["layers"][n]))
                   for n in jquant.QUANTIZABLE}
    layers = dict(jp["layers"])
    for name in jquant.QUANTIZABLE:
        layers[name] = QUANT[mode][0](layers[name])
    jp = {**jp, "layers": layers}
    tp = from_jax_params({"language_model": jax.tree.map(np.asarray, jp)}
                         )["language_model"]
    qfn = tquant.quant_fn(mode)
    for name in tquant.QUANTIZABLE:
        carried = tp["layers"][name]
        assert set(carried) == {"q4", "gs" if mode == "int4g" else "s"}
        assert carried["q4"].dtype == torch.int8
        for li in range(cfg_t.num_layers):
            own = qfn(fp32_layers[name][li])
            for k in own:
                torch.testing.assert_close(carried[k][li], own[k], atol=0, rtol=0)

    rng = np.random.default_rng(0)
    B, T, S = 2, 12, 20
    x = rng.standard_normal((B, T, cfg_j.hidden_size), np.float32)
    mask = _prompt_mask(B, T, (0, 5))
    pos = np.asarray(jllama.positions_from_mask(jnp.asarray(mask)))
    jc = jllama.init_kv_cache(cfg_j, B, S, quantized=False, layout="shbd")
    jh, jc = jllama.forward(jp, cfg_j, jnp.asarray(x), jnp.asarray(mask),
                            jnp.asarray(pos), kv_cache=jc, self_attn=True,
                            cache_layout="shbd")
    tc = tllama.init_kv_cache(cfg_t, B, S)
    th, tc = tllama.forward(tp, cfg_t, torch.from_numpy(x), torch.from_numpy(mask),
                            torch.from_numpy(pos), kv_cache=tc, self_attn=True)
    valid = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid],
                               atol=1e-4, rtol=1e-4)
    window = np.concatenate([mask, np.ones((B, S - T), np.int32)], axis=1)
    xd = rng.standard_normal((B, 1, cfg_j.hidden_size), np.float32)
    pd = mask.sum(-1, keepdims=True).astype(np.int32)
    jh2, _ = jllama.forward(jp, cfg_j, jnp.asarray(xd), jnp.asarray(window),
                            jnp.asarray(pd), kv_cache=jc, cache_layout="shbd")
    th2, _ = tllama.forward(tp, cfg_t, torch.from_numpy(xd),
                            torch.from_numpy(window), torch.from_numpy(pd),
                            kv_cache=tc)
    np.testing.assert_allclose(th2.numpy(), np.asarray(jh2), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_random_init_quantizes_each_layer_as_drawn(mode):
    """``JanusModel.init(quantize=mode)`` draws the same weights as the
    unquantized init and quantizes each layer's matrix: equal to quantizing
    the stacked trunk at once."""
    cfg = tjanus.tiny_janus_config()
    plain = tjanus.JanusModel.init(cfg, seed=5, device="cpu")
    quant = tjanus.JanusModel.init(cfg, seed=5, quantize=mode, device="cpu")
    qfn = tquant.quant_fn(mode)
    for name in tquant.QUANTIZABLE:
        ref = qfn(plain.params["language_model"]["layers"][name])
        got = quant.params["language_model"]["layers"][name]
        assert set(got) == set(ref)
        for k in ref:
            torch.testing.assert_close(got[k], ref[k], atol=0, rtol=0)
    torch.testing.assert_close(quant.params["gen_head"]["head"]["w"],
                               plain.params["gen_head"]["head"]["w"])


def test_load_janus_quantizes_int4g_layer_by_layer(tmp_path):
    from ospo_tpu.models.synthetic import write_synthetic_checkpoint
    from ospo_tpu_torch.models import weights as tweights

    path = write_synthetic_checkpoint(str(tmp_path / "ckpt"),
                                      jjanus.tiny_janus_config(), seed=2)
    m = tweights.load_janus(path, device="cpu", quantize="int4g")
    full = tweights.load_janus(path, device="cpu")
    for name in ("wq", "w_down"):
        got = m.params["language_model"]["layers"][name]
        ref = tquant.quantize_matrix_int4_group(
            full.params["language_model"]["layers"][name])
        for k in ("q4", "gs"):
            torch.testing.assert_close(got[k], ref[k], atol=0, rtol=0)


@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_get_model_serves_int4_modes(mode, capsys):
    from ospo_tpu_torch.pipeline.model_factory import get_model

    model, _, _ = get_model({"model_preset": "tiny", "device": "cpu",
                             "quantize": mode})
    w = model.params["language_model"]["layers"]["w_up"]
    assert set(w) == {"q4", "gs" if mode == "int4g" else "s"}
    assert w["q4"].shape == (2, 64, 64) and w["q4"].dtype == torch.int8
    assert f"# Quantizing language-model weights to {mode} (W4A16)." in \
        capsys.readouterr().out


@pytest.mark.parametrize("mode", ["int4g", "int4"])
def test_forced_cfg_logits_int4_match_jax(mode):
    """The whole slice with int4 weights: prompt batch, prefill (the T > 1
    forms), 63 cached decode steps (the decode matmul's plain version), int8
    shbd KV, fp32 CFG combine; the trunk quantized by the JAX package and
    carried across by ``from_jax_params``.  fp32; logits within 2e-4 (the
    int8 KV rows may round a tie differently)."""
    from ospo_tpu.engine.image_engine import ImageGenEngine as JEngine
    from ospo_tpu.image_processing import ImageProcessor
    from ospo_tpu.processing import Processor as JProcessor
    from ospo_tpu.processing import t2i_prompt as j_t2i
    from ospo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine as TEngine
    from ospo_tpu_torch.processing import Processor as TProcessor
    from ospo_tpu_torch.processing import t2i_prompt as t_t2i
    from ospo_tpu_torch.tokenizer import ByteTokenizer as TByteTokenizer

    cfg = jjanus.tiny_janus_config()
    params = np_janus_params(cfg, 1)
    lm = dict(params["language_model"])
    lm["layers"] = {n: (QUANT[mode][0](w) if n in jquant.QUANTIZABLE else w)
                    for n, w in lm["layers"].items()}
    params = {**params, "language_model": lm}
    jmodel = jjanus.JanusModel(cfg, params)
    tmodel = tjanus.JanusModel(tjanus.tiny_janus_config(),
                               from_jax_params(jax.tree.map(np.asarray, params)),
                               torch.device("cpu"))
    jproc = JProcessor(JByteTokenizer(512), ImageProcessor(image_size=16),
                       num_image_tokens=4)
    tproc = TProcessor(TByteTokenizer(512))
    n_img = cfg.num_gen_tokens
    forced = np.random.default_rng(1).integers(0, cfg.image_token_size, (2, n_img))
    prompts = ["A red cube on top of a blue sphere", "Two cats"]
    jeng = JEngine(jmodel, jproc, image_token_num=n_img, img_size=16,
                   patch_size=2, kv_quant="int8", kv_layout="shbd")
    teng = TEngine(tmodel, tproc, image_token_num=n_img, img_size=16,
                   patch_size=2, kv_quant="int8")
    ref = jeng.forced_cfg_logits([j_t2i(jproc, p) for p in prompts], forced)
    got = teng.forced_cfg_logits([t_t2i(tproc, p) for p in prompts], forced)
    assert got.shape == ref.shape == (2, n_img, cfg.image_token_size)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)


def test_step3_main_int4g_writes_the_same_tree_as_jax(tmp_path, capsys):
    """Step 3 on the CPU with ``quantize: int4g`` (tiny preset, int8 shbd KV)
    in both packages: the same relative paths and metadata.json; the PNGs
    are 16x16 RGB."""
    import json
    import os

    from PIL import Image

    from ospo_tpu.config import Config as JConfig
    from ospo_tpu.pipeline import step3 as jstep3
    from ospo_tpu_torch.config import Config as TConfig
    from ospo_tpu_torch.pipeline import step3 as tstep3

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                           "examples", "step2", "long_prompt.json")
    base = {"seed_list": [0, 1, 2], "batch_size": 2, "model_preset": "tiny",
            "data_path": fixture, "e_idx": 1, "quantize": "int4g",
            "kv_quant": "int8", "kv_layout": "shbd",
            "generation_config": {"temperature": 1.0, "cfg_weight": 5.0},
            "decode_segments": 1, "drop_lm_head": True}
    jstep3.main(JConfig.from_nested({**base, "save_path": str(tmp_path / "j")}))
    stats = tstep3.main(TConfig.from_nested({
        **base, "save_path": str(tmp_path / "t"), "device": "cpu"}))
    assert "# Quantizing language-model weights to int4g (W4A16)." in \
        capsys.readouterr().out

    def tree(root):
        out = {}
        for dirpath, _, files in os.walk(root):
            for name in files:
                rel = os.path.relpath(os.path.join(dirpath, name), root)
                if not rel.endswith("engine_stats.json"):
                    out[rel] = (json.load(open(os.path.join(dirpath, name)))
                                if name.endswith(".json") else None)
        return out

    ttree = tree(tmp_path / "t")
    assert ttree == tree(tmp_path / "j")
    assert stats["groups"] == 6 and stats["images"] == 6
    for rel in ttree:
        if rel.endswith(".png"):
            img = np.asarray(Image.open(tmp_path / "t" / rel))
            assert img.shape == (16, 16, 3) and img.dtype == np.uint8
