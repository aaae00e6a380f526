"""Port ops (``ospo_tpu_torch.ops``) against the JAX package on the CPU.

The CUDA kernels' plain PyTorch versions (what CPU tensors take) are held
against the Pallas kernels run in interpret mode, as ``tests/test_attention``
and ``tests/test_decode_attention`` run them.  Inputs come from numpy with a
seed and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ospo_tpu.ops.attention import xla_attention as jxla_attention
from ospo_tpu.ops import quant as jquant
from ospo_tpu.ops.decode_attention import decode_attention as jdecode
from ospo_tpu.ops.flash_attention import flash_attention as jflash
from ospo_tpu_torch.ops import attention as tattn
from ospo_tpu_torch.ops import flash_attention as fa
from ospo_tpu_torch.ops import quant as tquant
from ospo_tpu_torch.ops.decode_attention import decode_attention
from ospo_tpu_torch.ops.flash_attention import flash_attention
from ospo_tpu_torch.ops.sampling import sample_categorical

import flash_bwd_reference as ref

torch.set_num_threads(2)
# torch's CPU exp (MKL's vector math) sets itself up on its first call; in
# some processes the worker thread's share of that first parallel call came
# out ~1e-4 off, and every later call was exact: make that call here, once on
# this thread and once spread over both threads
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# flash forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,kvh", [(128, 4), (200, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(t, kvh, causal):
    """fp32 on both sides; tolerance 2e-5 (summation order).  Rows whose
    allowed keys are all masked (left-pad rows) are defined differently by
    the two (the module docstring), so the valid rows are compared."""
    rng = np.random.default_rng(0)
    b, h, d = 2, 4, 128
    q = rng.standard_normal((b, t, h, d), np.float32)
    k = rng.standard_normal((b, t, kvh, d), np.float32)
    v = rng.standard_normal((b, t, kvh, d), np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, :7] = 0
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask=jnp.asarray(mask), causal=causal,
                            blk_q=128, blk_k=128, interpret=True))
    out = flash_attention(_t(q), _t(k), _t(v), mask=_t(mask), causal=causal)
    valid = mask.astype(bool) if causal else np.ones((b, t), bool)
    np.testing.assert_allclose(out.numpy()[valid], ref[valid],
                               atol=2e-5, rtol=2e-5)


def test_flash_plain_pad_rows_average_their_window():
    """A fully masked query row gets the mean of V over its causal window;
    l counts that window and m is the -1e30 fill."""
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.standard_normal((1, 8, 2, 16), np.float32))
               for _ in range(3))
    mask = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 1]], dtype=torch.int32)
    out, l, m = flash_attention(q, k, v, mask=mask, causal=True,
                                return_stats=True)
    for i in range(3):
        torch.testing.assert_close(out[0, i], v[0, : i + 1].mean(0))
        assert float(l[0, 0, i]) == i + 1
        assert float(m[0, 0, i]) == float(torch.tensor(-1e30))


@pytest.mark.parametrize("q_offset,t", [(0, 12), (5, 3)])
def test_xla_attention_matches_jax(q_offset, t):
    """The plain masked attention, fully masked rows included (both fill
    -1e30 over the whole window); tolerance 2e-6."""
    rng = np.random.default_rng(2)
    s = 12
    q = rng.standard_normal((2, t, 4, 16), np.float32)
    k = rng.standard_normal((2, s, 2, 16), np.float32)
    v = rng.standard_normal((2, s, 2, 16), np.float32)
    mask = np.ones((2, s), np.int32)
    mask[0, :4] = 0
    ref = jxla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), q_offset, causal=True)
    out = tattn.xla_attention(_t(q), _t(k), _t(v), _t(mask), q_offset, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6,
                               rtol=2e-6)


def test_attention_dispatch():
    """Self-attention prefill takes the flash path; an offset read takes
    the plain masked attention."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.standard_normal((1, 6, 2, 16), np.float32))
               for _ in range(3))
    mask = torch.ones((1, 6), dtype=torch.int32)
    torch.testing.assert_close(tattn.attention(q, k, v, mask),
                               flash_attention(q, k, v, mask))
    torch.testing.assert_close(tattn.attention(q[:, :2], k, v, mask, q_offset=4),
                               tattn.xla_attention(q[:, :2], k, v, mask, 4))


# ---------------------------------------------------------------------------
# flash backward
# ---------------------------------------------------------------------------


def _bwd_case(seed, b=2, t=70, h=4, kvh=2, d=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d), np.float32)
    k = rng.standard_normal((b, t, kvh, d), np.float32)
    v = rng.standard_normal((b, t, kvh, d), np.float32)
    g = rng.standard_normal((b, t, h, d), np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, 9] = 0  # one masked key inside every later row's window
    return q, k, v, g, mask


def _jax_vjp(q, k, v, g, mask, causal):
    fn = lambda q_, k_, v_: jflash(q_, k_, v_, mask=jnp.asarray(mask),  # noqa: E731
                                   causal=causal, blk_q=128, blk_k=128,
                                   interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("causal,kvh", [(True, 2), (False, 2), (True, 4)])
def test_flash_backward_matches_jax_custom_vjp(causal, kvh):
    """The plain backward from the port's forward statistics, and the
    autograd path, against ``jax.vjp`` of the Pallas flash attention in
    interpret mode (its custom VJP, the dQ and dK/dV kernels).  GQA 4/2 and
    MHA; a masked key; T=70 (not a tile multiple).  fp32 both sides;
    tolerance 2e-5 absolute and relative (summation order)."""
    q, k, v, g, mask = _bwd_case(10, kvh=kvh)
    ref = _jax_vjp(q, k, v, g, mask, causal)
    tq, tk, tv, tg, tm = (_t(x) for x in (q, k, v, g, mask))
    out, l, m = flash_attention(tq, tk, tv, tm, causal=causal,
                                return_stats=True)
    plain = fa.flash_attention_bwd_plain(tq, tk, tv, tm, out, l, m, tg,
                                         causal=causal)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    o2 = tattn.attention(*leaves, mask=tm, causal=causal, impl="flash")
    auto = torch.autograd.grad(o2, leaves, tg)
    for name, r, p, a in zip(("dq", "dk", "dv"), ref, plain, auto):
        assert p.shape == a.shape == r.shape, name
        np.testing.assert_allclose(p.numpy(), r, atol=2e-5, rtol=2e-5,
                                   err_msg=name)
        torch.testing.assert_close(a, p, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_matches_autograd_of_xla_attention(causal):
    """The flash path's gradients against torch autograd through the plain
    masked attention (``xla_attention``): same function wherever a row has
    a valid key, so a masked key mid-sequence (not a pad row).  fp32;
    tolerance 2e-5."""
    q, k, v, g, mask = _bwd_case(11, t=40, d=128)
    grads = []
    for impl in ("flash", "xla"):
        leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
        out = tattn.attention(*leaves, mask=_t(mask), causal=causal, impl=impl)
        grads.append(torch.autograd.grad(out, leaves, _t(g)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_flash_backward_wrappers_take_the_plain_path_on_cpu():
    """On CPU tensors the dQ and dK/dV wrappers are their plain versions
    and launch nothing."""
    q, k, v, g, mask = (_t(x) for x in _bwd_case(12, t=20))
    out, l, m = flash_attention(q, k, v, mask, return_stats=True)
    di = fa.row_dot(out, g)
    n0 = (fa.dq_launches, fa.dkv_launches)
    torch.testing.assert_close(fa.flash_dq(q, k, v, mask, g, m, l, di),
                               fa.flash_dq_plain(q, k, v, mask, g, m, l, di))
    for a, b in zip(fa.flash_dkv(q, k, v, mask, g, m, l, di),
                    fa.flash_dkv_plain(q, k, v, mask, g, m, l, di)):
        torch.testing.assert_close(a, b)
    assert (fa.dq_launches, fa.dkv_launches) == n0


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_plain_fp32_rounds_nothing(causal):
    """The plain backward keeps p and ds in fp32, as the TPU kernels do: it
    equals the written-out formulas of ``flash_bwd_reference.backward`` bit
    for bit, from fp32 inputs and from bf16 ones (rounded to bf16 at the
    end)."""
    q, k, v, g, mask = (_t(x) for x in _bwd_case(15))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
        out, l, m = flash_attention(q, k, v, mask, causal=causal,
                                    return_stats=True)
        di = fa.row_dot(out, g)
        got = (fa.flash_dq_plain(q, k, v, mask, g, m, l, di, causal),
               *fa.flash_dkv_plain(q, k, v, mask, g, m, l, di, causal))
        want = ref.backward(q, k, v, mask, g, m, l, di, causal)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a, b.to(dtype), atol=0, rtol=0,
                                       msg=f"{name} {dtype}")


def test_flash_backward_float64_reference_matches_plain():
    """The float64 yardstick of the rounding budget,
    ``flash_bwd_reference.exact_backward`` (its own forward), against the
    plain backward on fp32 inputs: the same function, to 2e-5 of max|ref|."""
    q, k, v, g, mask = (_t(x) for x in _bwd_case(18))
    out, l, m = flash_attention(q, k, v, mask, return_stats=True)
    plain = fa.flash_attention_bwd_plain(q, k, v, mask, out, l, m, g)
    for name, a, b in zip(("dq", "dk", "dv"), plain,
                          ref.exact_backward(q, k, v, mask, g)):
        assert b.dtype == torch.float64, name
        err = float((a.double() - b).abs().max())
        assert err <= 2e-5 * float(b.abs().max()), (name, err)


def test_flash_backward_plain_bf16_matches_jax_custom_vjp():
    """bf16 inputs: the plain backward (p and ds in fp32) and the bf16
    kernels' scheme (p and ds rounded to bf16, emulated by
    ``flash_bwd_reference.backward``) against ``jax.vjp`` of the Pallas
    flash attention in interpret mode (p and ds in fp32, each head's
    gradient rounded before the GQA sum), within 2^-6 max|ref| per
    tensor."""
    q, k, v, g, mask = _bwd_case(16)
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    fn = lambda q_, k_, v_: jflash(q_, k_, v_, mask=jnp.asarray(mask),  # noqa: E731
                                   causal=True, blk_q=128, blk_k=128,
                                   interpret=True)
    _, vjp = jax.vjp(fn, bf(q), bf(k), bf(v))
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(bf(g))]
    tq, tk, tv, tg = (_t(x).to(torch.bfloat16) for x in (q, k, v, g))
    tm = _t(mask)
    out, l, m = flash_attention(tq, tk, tv, tm, return_stats=True)
    plain = fa.flash_attention_bwd_plain(tq, tk, tv, tm, out, l, m, tg)
    scheme = ref.backward(tq, tk, tv, tm, tg, m, l, fa.row_dot(out, tg),
                          round_p_ds=True)
    for name, a, e, r in zip(("dq", "dk", "dv"), plain, scheme, want):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape, name
        for what, x in (("plain", a), ("kernels' scheme", e)):
            err = float(np.abs(x.to(torch.bfloat16).float().numpy() - r).max())
            assert err <= 2 ** -6 * float(np.abs(r).max()), (name, what, err)


def _scheme_budget(seed, round_s):
    """``flash_bwd_reference.budget`` of the bf16 kernels' scheme (emulated,
    rounded to bf16 at the end), at the ``_bwd_case`` shape with q scaled
    as the budget's inputs are; ``round_s`` adds the control's rounding of
    the scores."""
    q, k, v, g, mask = (_t(x) for x in _bwd_case(seed))
    args = ref.budget_case(*(x.to(torch.bfloat16) for x in (q, k, v)), mask,
                           g.to(torch.bfloat16))
    got = [x.to(torch.bfloat16) for x in ref.backward(
        *args, round_p_ds=True, round_s=round_s)]
    return ref.budget(got, *args)


def test_flash_backward_bf16_rounding_budget():
    """The bf16 kernels' scheme (p and ds rounded to bf16) errs against a
    float64 backward at most ``BUDGET`` (2) times the RMS error of the plain
    backward (p and ds in fp32), both from the same bf16 inputs and fp32
    statistics and rounded to bf16 at the end.  The kernels on the card are
    held to the same rule (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
    for name, err, err_plain in _scheme_budget(17, round_s=False):
        assert err <= ref.BUDGET * err_plain, (name, err, err_plain)


def test_flash_backward_rounding_budget_sees_rounded_scores():
    """The budget's control: the same scheme with the scores ``q . k`` also
    rounded to bf16 (precision a kernel must not lose) exceeds the budget in
    every tensor."""
    for name, err, err_plain in _scheme_budget(17, round_s=True):
        assert err > ref.BUDGET * err_plain, (name, err, err_plain)


def test_attention_impl_argument():
    """``impl`` as in the JAX dispatcher: flash refuses an offset, an
    unknown impl is an error, xla is the plain masked attention."""
    rng = np.random.default_rng(13)
    q, k, v = (_t(rng.standard_normal((1, 6, 2, 16), np.float32))
               for _ in range(3))
    with pytest.raises(ValueError, match="q_offset"):
        tattn.attention(q[:, :2], k, v, q_offset=4, impl="flash")
    with pytest.raises(ValueError, match="impl"):
        tattn.attention(q, k, v, impl="pallas")
    torch.testing.assert_close(tattn.attention(q, k, v, impl="xla"),
                               tattn.xla_attention(q, k, v, None))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def _decode_case(kind, seed=0, L=3, S=256, H=4, B=2, dh=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, dh), np.float32)
    kc = rng.standard_normal((L, S, H, B, dh), np.float32)
    vc = rng.standard_normal((L, S, H, B, dh), np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :5] = 0  # left padding
    if kind == "int8":
        ks = np.abs(rng.standard_normal((L, S, H, B), np.float32)) * 0.02 + 1e-3
        vs = np.abs(rng.standard_normal((L, S, H, B), np.float32)) * 0.02 + 1e-3
        kc = rng.integers(-127, 128, kc.shape).astype(np.int8)
        vc = rng.integers(-127, 128, vc.shape).astype(np.int8)
        return q, kc, vc, ks, vs, mask
    return q, kc, vc, None, None, mask


@pytest.mark.parametrize("cur_len", [6, 64, 170])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_decode_plain_matches_pallas(kind, cur_len):
    """fp32 math on both sides from the same cache values (a bf16 cache is
    the bf16 rounding of the same normals); tolerance 3e-5."""
    q, kc, vc, ks, vs, mask = _decode_case(kind)
    li = 1
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    tk, tv = _t(kc), _t(vc)
    if kind == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    ref = jdecode(jnp.asarray(q), jk, jv, li, cur_len, jnp.asarray(mask),
                  k_scale=None if ks is None else jnp.asarray(ks),
                  v_scale=None if vs is None else jnp.asarray(vs),
                  interpret=True)
    out = decode_attention(_t(q), tk, tv, li, cur_len, _t(mask),
                           None if ks is None else _t(ks),
                           None if vs is None else _t(vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=3e-5)


def test_decode_plain_fully_masked_row_and_empty_cache():
    """A row with every populated key masked averages (scaled) V over
    [0, cur_len) — the Pallas kernel agrees when cur_len is a multiple of
    its 64-position block; cur_len 0 gives zeros."""
    q, kc, vc, ks, vs, mask = _decode_case("int8", seed=4)
    mask[0] = 0
    ref = jdecode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), 2, 128,
                  jnp.asarray(mask), k_scale=jnp.asarray(ks),
                  v_scale=jnp.asarray(vs), interpret=True)
    out = decode_attention(_t(q), _t(kc), _t(vc), 2, 128, _t(mask), _t(ks),
                           _t(vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=3e-5)
    zero = decode_attention(_t(q), _t(kc), _t(vc), 2, 0, _t(mask), _t(ks),
                            _t(vs))
    assert not zero.any()


def test_decode_plain_ignores_tail():
    """Positions at or past cur_len never influence the output."""
    q, kc, vc, _, _, mask = _decode_case("f32", seed=5)
    out1 = decode_attention(_t(q), _t(kc), _t(vc), 1, 100, _t(mask))
    kc[:, 100:], vc[:, 100:] = 99.0, -99.0
    out2 = decode_attention(_t(q), _t(kc), _t(vc), 1, 100, _t(mask))
    torch.testing.assert_close(out1, out2, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matrix_bit_equal(dtype):
    rng = np.random.default_rng(6)
    w = rng.standard_normal((3, 48, 64), np.float32) * 0.02
    w[0, 5] = 0.0  # an all-zero row takes the 1e-12 scale floor
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = _t(w).to(getattr(torch, dtype))
    ref = jquant.quantize_matrix(jw)
    out = tquant.quantize_matrix(tw)
    np.testing.assert_array_equal(out["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(out["s"].numpy(), np.asarray(ref["s"]))


def test_quantize_rows_equal():
    from ospo_tpu.models.llama import _quantize_rows as jrows
    from ospo_tpu_torch.models.llama import _quantize_rows as trows

    x = np.random.default_rng(7).standard_normal((5, 4, 3, 32), np.float32)
    jq, js = jrows(jnp.asarray(x))
    tq, ts = trows(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantized_matmul_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 64), np.float32)
    qw = jquant.quantize_matrix(jnp.asarray(rng.standard_normal((40, 64),
                                                                np.float32)))
    ref = jquant.quantized_matmul(jnp.asarray(x), qw)
    out = tquant.quantized_matmul(_t(x), {k: _t(v) for k, v in qw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("value", [None, False, True, "", "bf16", "INT8",
                                   " int4 ", "on", "off", "0"])
def test_parse_kv_quant_equal(value):
    assert tquant.parse_kv_quant(value) == jquant.parse_kv_quant(value)


def test_parse_kv_quant_rejects_typos():
    with pytest.raises(ValueError):
        tquant.parse_kv_quant("int_8")


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def test_sampling_matches_distribution():
    """Chi-square goodness of fit of 40k draws from fixed logits at
    temperature 0.7 (7 degrees of freedom; the 99.9% quantile is 24.3)."""
    logits = torch.tensor([1.0, 0.5, -0.3, 2.0, 0.0, -1.0, 1.5, 0.2])
    gen = torch.Generator().manual_seed(0)
    n = 40_000
    draws = sample_categorical(logits.expand(n, 8), 0.7, gen)
    counts = torch.bincount(draws, minlength=8).double()
    expected = torch.softmax(logits.double() / 0.7, -1) * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.3, chi2


def test_sampling_temperature_floor_is_greedy():
    """temperature 0 is floored at 1e-6: the draw is the argmax."""
    logits = torch.tensor([[0.1, 3.0, 2.9], [5.0, -1.0, 4.99]])
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        assert sample_categorical(logits, 0.0, gen).tolist() == [1, 0]
