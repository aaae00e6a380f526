"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present and run on the
card with ``python -m pytest tests/test_torch_cuda.py -q``.  ``chip_smoke.py``
makes the same comparisons at the main path's full shapes.
"""

import pytest
import torch

from ospo_tpu_torch.utils.profiling import kernel_launches

pytestmark = pytest.mark.gpu


def _launched(before, *names):
    """The named kernels' launches since ``before``, a ``kernel_launches()``
    read."""
    now = kernel_launches()
    return tuple(now[n] - before[n] for n in names)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,kvh", [(True, 4), (False, 2)])
def test_flash_kernel_matches_plain(cuda, dtype, causal, kvh):
    from ospo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((3, 150, 4, 128), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((3, 150, kvh, 128), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    mask = torch.ones((3, 150), dtype=torch.int32, device=cuda)
    mask[1, :40] = 0
    n0 = kernel_launches()
    out, l, m = fa.flash_attention(q, k, v, mask, causal=causal,
                                   return_stats=True)
    ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, mask, causal=causal)
    assert _launched(n0, "flash_fwd") == (1,)
    # fp32 math on both sides; a bf16 output differs by its final rounding
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(l, l_ref, atol=0, rtol=1e-5)
    torch.testing.assert_close(m, m_ref, atol=1e-4, rtol=0)


def _fwd_inputs(cuda, b, t, h, kvh, seed, left_pad=False):
    """bf16 q, k, v and an int32 mask: one masked key in the last row, or
    left-padded rows of random length (row 0 unpadded), as a prefill's."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, t, h, 128), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, t, kvh, 128), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    if left_pad:
        lens = torch.randint(t // 6, t + 1, (b,), generator=g, device=cuda)
        lens[0] = t
        mask = (torch.arange(t, device=cuda)[None, :] >= (t - lens)[:, None]
                ).to(torch.int32).contiguous()
    else:
        mask = torch.ones((b, t), dtype=torch.int32, device=cuda)
        mask[-1, t // 3] = 0
    return q, k, v, mask


@pytest.mark.parametrize("b,t,h,left_pad", [(2, 704, 32, False),
                                            (6, 384, 8, True)])
def test_flash_forward_bf16_kernel_matches_plain(cuda, b, t, h, left_pad):
    """The tensor-core body (p rounded to bf16 before P . V; the plain
    version keeps it in fp32) at T=704 (2 rows of the training shape, all
    32 heads) and on a left-padded prefill, at the tolerances of
    ``test_flash_kernel_matches_plain``: O within 1e-2 + 1e-2 |O|, l within
    1e-5 relative, m within 1e-4."""
    from ospo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask = _fwd_inputs(cuda, b, t, h, h, 12, left_pad)
    out, l, m = fa.flash_attention(q, k, v, mask, return_stats=True)
    ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(l, l_ref, atol=0, rtol=1e-5)
    torch.testing.assert_close(m, m_ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,t,h,kvh", [(3, 200, 4, 2), (2, 704, 32, 32)])
def test_flash_forward_bf16_kernel_within_the_rounding_budget(cuda, b, t, h,
                                                              kvh):
    """bf16: against a float64 forward from the same inputs, the kernel's
    RMS error in O is at most ``BUDGET`` (2) times the plain forward's (p in
    fp32, O rounded to bf16 at the end); ``flash_fwd_reference`` has the
    rule and its inputs (q scaled so that the attention is peaked)."""
    import flash_fwd_reference as fref
    from ospo_tpu_torch.ops import flash_attention as fa

    args = fref.budget_case(*_fwd_inputs(cuda, b, t, h, kvh, 13))
    err, err_plain = fref.budget(fa.flash_attention(*args), *args)
    assert err <= fref.BUDGET * err_plain, (err, err_plain)


@pytest.mark.parametrize("t,h,kvh", [(77, 4, 2), (704, 4, 4)])
def test_flash_forward_bf16_stats_feed_the_backward_kernels(cuda, t, h, kvh):
    """The bf16 forward kernel's O, m and l drive the dQ and dK/dV kernels;
    their gradients stay within the bf16 tolerance of ``_assert_bwd_close``
    of the plain backward driven by the plain forward's O, m and l (the
    kernels scale the scores after the product, as the forward now does)."""
    q, k, v, do, mask, fa = _bwd_inputs(cuda, torch.bfloat16, 3, t, h, kvh, 14)
    out, l, m = fa.flash_attention(q, k, v, mask, return_stats=True)
    di = fa.row_dot(out, do)
    got = (fa.flash_dq(q, k, v, mask, do, m, l, di),
           *fa.flash_dkv(q, k, v, mask, do, m, l, di))
    ref_out, ref_l, ref_m = fa.flash_attention_plain(q, k, v, mask)
    want = fa.flash_attention_bwd_plain(q, k, v, mask, ref_out, ref_l, ref_m,
                                        do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_bwd_close(a, b, torch.bfloat16, name)


def _bwd_inputs(cuda, dtype, b, t, h, kvh, seed):
    from ospo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, t, h, 128), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((b, t, kvh, 128), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn((b, t, h, 128), generator=g, device=cuda).to(dtype)
    mask = torch.ones((b, t), dtype=torch.int32, device=cuda)
    mask[-1, t // 3] = 0
    return q, k, v, do, mask, fa


def _assert_bwd_close(got, ref, dtype, name):
    """fp32 (CUDA-core body): within 1e-4, the order of the fp32 sums.
    bf16 (tensor-core body, which rounds p and ds to bf16 where the plain
    version keeps them in fp32): within 2^-8 max|ref| + 2^-7 |ref| per
    tensor, i.e. the final bf16 step plus what the rounding of p and ds
    moves (a sum over a row's keys, so a share of the row's scale, not of
    the element's own value, hence the max|ref| term; ~1.5e-3 max|ref| in a
    CPU emulation of the kernel at T=704)."""
    assert got.dtype == dtype and got.shape == ref.shape, name
    if dtype == torch.float32:
        atol, rtol = 1e-4, 1e-4
    else:
        atol, rtol = 2 ** -8 * float(ref.float().abs().max()), 2 ** -7
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol,
                               msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,h,kvh,causal", [(128, 4, 4, True),
                                            (77, 4, 2, True),
                                            (150, 6, 2, False),
                                            (704, 4, 4, True)])
def test_flash_backward_kernels_match_plain(cuda, dtype, t, h, kvh, causal):
    """dQ and dK/dV kernels against their plain versions on the same
    inputs and forward statistics: T a tile multiple and ragged, GQA, a
    masked key, and T=704 (eleven 64-key tiles, the diagonal of the last at
    a non-tile row); tolerances as ``_assert_bwd_close``."""
    q, k, v, do, mask, fa = _bwd_inputs(cuda, dtype, 3, t, h, kvh, 3)
    out, l, m = fa.flash_attention(q, k, v, mask, causal=causal,
                                   return_stats=True)
    di = fa.row_dot(out, do)
    n0 = kernel_launches()
    dq = fa.flash_dq(q, k, v, mask, do, m, l, di, causal)
    dk, dv = fa.flash_dkv(q, k, v, mask, do, m, l, di, causal)
    torch.cuda.synchronize()
    assert _launched(n0, "flash_bwd_dq", "flash_bwd_dkv") == (1, 1)
    ref_dq = fa.flash_dq_plain(q, k, v, mask, do, m, l, di, causal)
    ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, mask, do, m, l, di, causal)
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                           ("dv", dv, ref_dv)):
        _assert_bwd_close(got, ref, dtype, name)


@pytest.mark.parametrize("t,h,kvh", [(77, 4, 2), (704, 4, 4)])
def test_flash_backward_bf16_kernels_within_the_rounding_budget(cuda, t, h,
                                                                 kvh):
    """bf16: against a float64 backward from the same inputs (its own
    float64 forward), the kernels' RMS error is at most ``BUDGET`` (2) times
    the plain backward's (p and ds in fp32, the same fp32 statistics,
    rounded to bf16 at the end); ``flash_bwd_reference`` has the rule and
    its inputs (q scaled so that the attention is peaked)."""
    import flash_bwd_reference as ref

    q, k, v, do, mask, fa = _bwd_inputs(cuda, torch.bfloat16, 3, t, h, kvh, 5)
    args = ref.budget_case(q, k, v, mask, do)
    got = (fa.flash_dq(*args), *fa.flash_dkv(*args))
    for name, err, err_plain in ref.budget(got, *args):
        assert err <= ref.BUDGET * err_plain, (name, err, err_plain)


def test_flash_autograd_on_cuda_never_takes_the_plain_path(cuda, monkeypatch):
    """A CUDA tensor in the differentiable path launches the three kernels
    (the plain versions are replaced by a trap) and its gradients equal the
    plain backward's."""
    from ospo_tpu_torch.ops import attention as tattn

    q, k, v, do, mask, fa = _bwd_inputs(cuda, torch.float32, 2, 96, 4, 2, 4)
    out, l, m = fa.flash_attention_plain(q, k, v, mask)
    ref = fa.flash_attention_bwd_plain(q, k, v, mask, out, l, m, do)

    def trap(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("flash_attention_plain", "flash_dq_plain", "flash_dkv_plain"):
        monkeypatch.setattr(fa, name, trap)
    n0 = kernel_launches()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = tattn.attention(*leaves, mask=mask, impl="flash")
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert _launched(n0, "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") == \
        (1, 1, 1)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flash_autograd_on_cuda_never_takes_the_plain_path_bf16(cuda,
                                                               monkeypatch):
    """The same in bf16, through the tensor-core bodies of the dQ and dK/dV
    kernels; gradients within the bf16 tolerance of
    ``_assert_bwd_close`` of the plain backward (the forward's O and
    statistics differ from the plain forward's by their own rounding)."""
    from ospo_tpu_torch.ops import attention as tattn

    q, k, v, do, mask, fa = _bwd_inputs(cuda, torch.bfloat16, 2, 96, 4, 2, 4)
    out, l, m = fa.flash_attention_plain(q, k, v, mask)
    ref = fa.flash_attention_bwd_plain(q, k, v, mask, out, l, m, do)
    for name in ("flash_attention_plain", "flash_dq_plain", "flash_dkv_plain"):
        monkeypatch.setattr(fa, name, _trap)
    n0 = kernel_launches()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = tattn.attention(*leaves, mask=mask, impl="flash")
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert _launched(n0, "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") == \
        (1, 1, 1)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        _assert_bwd_close(got, want, torch.bfloat16, name)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("cur_len", [0, 1, 65, 77, 256])
def test_decode_kernel_matches_plain(cuda, kind, cur_len):
    from ospo_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=cuda).manual_seed(1)
    L, S, H, B = 3, 256, 4, 6
    q = torch.randn((B, 1, H, 128), generator=g, device=cuda).bfloat16()
    if kind == "int8":
        kc, vc = (torch.randint(-127, 128, (L, S, H, B, 128), generator=g,
                                device=cuda, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((L, S, H, B), generator=g, device=cuda) * 0.02
                  for _ in range(2))
    else:
        kc, vc = (torch.randn((L, S, H, B, 128), generator=g, device=cuda)
                  .bfloat16() for _ in range(2))
        ks = vs = None
    mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
    mask[1, :30] = 0
    mask[2] = 0  # every key masked
    if cur_len == 65:
        # a one-position tail chunk whose key takes ~all of the softmax and
        # whose V is distinctive: dropping or mis-scaling it is off by ~3
        last, qt = cur_len - 1, q[:, 0].float().permute(1, 0, 2)
        if kind == "int8":
            kc[1, last] = (qt * 40).round().clamp(-127, 127).to(torch.int8)
            vc[1, last] = 127
            ks[1, last] = vs[1, last] = 0.05
        else:
            kc[1, last] = (qt * 2).bfloat16()
            vc[1, last] = 3.0
    out = da.decode_attention(q, kc, vc, 1, cur_len, mask, ks, vs)
    ref = da.decode_attention_plain(q, kc, vc, 1, cur_len, mask, ks, vs)
    # fp32 on both sides: the bf16 outputs differ by at most one rounding
    # step (2^-7 |ref|), plus fp32 summation order
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-4,
                               rtol=2 ** -7)
    if cur_len == 65:
        expect = 6.35 if kind == "int8" else 3.0
        valid = ref[mask[:, last] > 0].float()
        torch.testing.assert_close(valid, torch.full_like(valid, expect),
                                   atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("cur_len", [1, 63, 64, 65, 385, 449, 672, 960])
@pytest.mark.parametrize("B", [1, 3, 6, 48])
def test_decode_kernel_rows_and_lengths(cuda, B, cur_len, kind, q_dtype):
    """The row-grouped kernel (4 rows a warp, 8 lanes a row, split-K over
    blocks of up to 256 positions) against its plain version: B not a
    multiple of the row group (1, 3, 6) and the serving batch (48); cur_len
    at 1, around the 64-position and 256-position edges, with one-position
    tails, and at the serving point; int8 and bf16 caches, fp32 and bf16 q;
    a left-padded row and a row whose every key is masked.  Tolerance as
    ``test_decode_kernel_matches_plain``: 1e-4 + 2^-7 |ref|."""
    from ospo_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=cuda).manual_seed(B * 1000 + cur_len)
    L, S, H = 2, 960, 4
    q = torch.randn((B, 1, H, 128), generator=g, device=cuda).to(q_dtype)
    if kind == "int8":
        kc, vc = (torch.randint(-127, 128, (L, S, H, B, 128), generator=g,
                                device=cuda, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((L, S, H, B), generator=g, device=cuda) * 0.02
                  for _ in range(2))
    else:
        kc, vc = (torch.randn((L, S, H, B, 128), generator=g, device=cuda)
                  .bfloat16() for _ in range(2))
        ks = vs = None
    mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
    mask[0, :cur_len // 3] = 0           # left padding
    mask[B // 2] = 0                     # every key masked
    n0 = kernel_launches()
    out = da.decode_attention(q, kc, vc, 1, cur_len, mask, ks, vs)
    ref = da.decode_attention_plain(q, kc, vc, 1, cur_len, mask, ks, vs)
    torch.cuda.synchronize()
    assert _launched(n0, "decode_attention") == (1,) and out.dtype == q_dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-4,
                               rtol=2 ** -7)


def test_bf16_kernels_refuse_misaligned_pointers(cuda):
    """The tensor-core flash forward and the decode kernel read 16 bytes a
    lane: a tensor whose data does not start on a 16-byte boundary is
    refused, not read."""
    from ospo_tpu_torch.ops import decode_attention as da
    from ospo_tpu_torch.ops import flash_attention as fa

    n = 2 * 64 * 2 * 128
    q = torch.zeros(n + 1, dtype=torch.bfloat16, device=cuda)[1:].view(
        2, 64, 2, 128)
    k = torch.zeros((2, 64, 2, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        fa.flash_attention(q, k, k)
    qd = torch.zeros((2, 1, 2, 128), device=cuda)
    cache = torch.zeros(1 * 16 * 2 * 2 * 128 + 4, dtype=torch.bfloat16,
                        device=cuda)[4:].view(1, 16, 2, 2, 128)  # 8 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.decode_attention(qd, cache, cache, 0, 4,
                            torch.ones((2, 16), dtype=torch.int32, device=cuda))


def _int4_inputs(cuda, mode, m, f, d, dtype, seed, group=128):
    from ospo_tpu_torch.ops import quant

    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((f, d), generator=g, device=cuda) * 0.05
    w[:, :3] *= 8.0                      # outlier columns: row and group differ
    qw = (quant.quantize_matrix_int4_group(w.to(dtype), group) if mode == "int4g"
          else quant.quantize_matrix_int4(w.to(dtype)))
    x = (torch.randn((m, 1, d), generator=g, device=cuda) * 0.5).to(dtype)
    return x, qw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,f,d", [(1, 256, 256), (8, 512, 384), (40, 200, 256),
                                   (2, 38, 112), (48, 4096, 1024),
                                   (130, 96, 2048), (256, 130, 64)])
@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_int4_kernels_match_plain(cuda, mode, m, f, d, dtype):
    """The row and group kernels against their plain version: small, ragged
    (F/2 and M no multiple of the tiles, more than one M tile) and split-D
    shapes.  The products are exact in fp32 on both sides, so the outputs
    differ by the order of the fp32 sums: fp32 within 1e-5 (absolute and
    relative to max |ref|); bf16 within one rounding step (2^-7 |ref|, and
    one step more where the row scale rounds after), plus 1e-3 max |ref|."""
    from ospo_tpu_torch.ops import int4_matmul as i4

    x, qw = _int4_inputs(cuda, mode, m, f, d, dtype, 5)
    n0 = kernel_launches()
    got = i4.int4_matmul_decode(x, qw)
    ref = i4.int4_matmul_decode_plain(x, qw)
    torch.cuda.synchronize()
    assert _launched(n0, "int4_matmul_group" if mode == "int4g"
                     else "int4_matmul_row") == (1,)
    assert got.dtype == dtype and got.shape == (m, 1, f)
    scale = float(ref.float().abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-3 * scale,
                                   rtol=2 ** -6 if mode == "int4" else 2 ** -7)


def _assert_int4_close(got, ref, mode, dtype):
    """The tolerances of ``test_int4_kernels_match_plain``: fp32 within 1e-5
    (absolute, of max |ref|, and relative); bf16 within one rounding step
    (2^-7 |ref|, 2^-6 for the row form) plus 1e-3 max |ref|."""
    assert got.dtype == dtype and got.shape == ref.shape
    scale = float(ref.float().abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-3 * scale,
                                   rtol=2 ** -6 if mode == "int4" else 2 ** -7)


@pytest.mark.parametrize("f,d", [(4096, 4096), (11008, 4096), (4096, 11008)])
@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_int4_kernels_at_the_7b_shapes(cuda, mode, f, d):
    """The 7B projections at the serving point (M = 48, bf16; the clusters of
    8, 4 and 8 blocks) against the plain version."""
    from ospo_tpu_torch.ops import int4_matmul as i4

    x, qw = _int4_inputs(cuda, mode, 48, f, d, torch.bfloat16, 10)
    _assert_int4_close(i4.int4_matmul_decode(x, qw),
                       i4.int4_matmul_decode_plain(x, qw), mode, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 47, 49, 64, 65, 256])
@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_int4_kernels_rows_of_x(cuda, mode, m, dtype):
    """Every edge of the n8 tiles and of the 64-row x tiles, F/2 = 200 (no
    multiple of the 64-row block), D = 1040 (16 columns past 16 chunks;
    groups of 80 columns)."""
    from ospo_tpu_torch.ops import int4_matmul as i4

    x, qw = _int4_inputs(cuda, mode, m, 400, 1040, dtype, 11 + m, group=80)
    _assert_int4_close(i4.int4_matmul_decode(x, qw),
                       i4.int4_matmul_decode_plain(x, qw), mode, dtype)


@pytest.mark.parametrize("f2,d", [(1, 16), (37, 80), (65, 4112), (127, 11008)])
@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_int4_kernels_ragged_rows(cuda, mode, f2, d):
    """Ragged F/2 (one row; 37, 65 and 127 packed rows) with ragged or long
    D (groups of 16 columns where 128 does not divide D), bf16 at M = 48."""
    from ospo_tpu_torch.ops import int4_matmul as i4

    x, qw = _int4_inputs(cuda, mode, 48, 2 * f2, d, torch.bfloat16, 12,
                         group=128 if d % 128 == 0 else 16)
    _assert_int4_close(i4.int4_matmul_decode(x, qw),
                       i4.int4_matmul_decode_plain(x, qw), mode, torch.bfloat16)


@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_int4_kernels_extreme_nibbles(cuda, mode):
    """Every nibble at -8 or +7 (both planes), |x| up to ~400, D = 11008,
    scales spread over four decades: the decode's extremes and long fp32
    sums, bf16 at M = 48."""
    from ospo_tpu_torch.ops import int4_matmul as i4

    g = torch.Generator(device=cuda).manual_seed(13)
    f2, d = 256, 11008
    lo = torch.where(torch.rand((f2, d), generator=g, device=cuda) < 0.5, -8, 7)
    hi = torch.where(torch.rand((f2, d), generator=g, device=cuda) < 0.5, -8, 7)
    q4 = ((lo & 0xF) | (hi << 4)).to(torch.uint8).view(torch.int8).contiguous()
    from ospo_tpu_torch.ops import quant

    for plane in quant.unpack_int4_halves(q4):
        assert set(plane.unique().tolist()) == {-8, 7}
    spread = 10.0 ** torch.randint(-4, 0, (2 * f2,), generator=g, device=cuda)
    if mode == "int4g":
        gs = torch.rand((2 * f2, d // 128), generator=g, device=cuda) \
            * spread[:, None]
        qw = {"q4": q4, "gs": gs.contiguous()}
    else:
        qw = {"q4": q4, "s": (torch.rand((2 * f2,), generator=g, device=cuda)
                              * spread).contiguous()}
    x = (torch.randn((48, 1, d), generator=g, device=cuda) * 100.0
         ).to(torch.bfloat16)
    _assert_int4_close(i4.int4_matmul_decode(x, qw),
                       i4.int4_matmul_decode_plain(x, qw), mode, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_int4_kernels_are_deterministic(cuda, mode, dtype):
    """Two calls on the same input give bit-identical output (w_down at the
    serving point: the bf16 body's cluster of 8 blocks, the fp32 body's
    second pass)."""
    from ospo_tpu_torch.ops import int4_matmul as i4

    x, qw = _int4_inputs(cuda, mode, 48, 4096, 11008, dtype, 14)
    a = i4.int4_matmul_decode(x, qw)
    b = i4.int4_matmul_decode(x, qw)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_int4_projection_on_cuda_never_takes_the_plain_path(cuda, monkeypatch):
    """A T == 1 int4 / int4g projection of the trunk (``llama.linear``) on
    CUDA launches the kernel (the plain version is replaced by a trap) and
    agrees with the plain version's output."""
    from ospo_tpu_torch.models import llama
    from ospo_tpu_torch.ops import int4_matmul as i4

    for mode in ("int4", "int4g"):
        x, qw = _int4_inputs(cuda, mode, 6, 256, 256, torch.bfloat16, 6)
        ref = i4.int4_matmul_decode_plain(x, qw)
        with monkeypatch.context() as mp:
            mp.setattr(i4, "int4_matmul_decode_plain", _trap)
            n0 = kernel_launches()
            got = llama.linear(x, qw)
            torch.cuda.synchronize()
            moved = _launched(n0, "int4_matmul_row", "int4_matmul_group")
        assert moved == ((0, 1) if mode == "int4g" else (1, 0))
        scale = float(ref.float().abs().max())
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-3 * scale,
                                   rtol=2 ** -6)


def _trap(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached a plain version")


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from ospo_tpu_torch.ops import decode_attention as da
    from ospo_tpu_torch.ops import flash_attention as fa

    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 128), device=cuda)
    stat = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="di"):
        fa.flash_dq(q, q, q, None, q, stat, stat, stat[:, :1])
    with pytest.raises(ValueError, match="dO"):
        fa.flash_dkv(q, q, q, None, q.bfloat16(), stat, stat, stat)
    qd = torch.zeros((2, 1, 2, 128), device=cuda)
    cache = torch.zeros((1, 16, 2, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="mask"):
        da.decode_attention(qd, cache, cache, 0, 4,
                            torch.ones((2, 16), device=cuda))

    from ospo_tpu_torch.ops import int4_matmul as i4

    x, qw = _int4_inputs(cuda, "int4g", 4, 64, 256, torch.bfloat16, 7)
    with pytest.raises(ValueError, match="M="):
        i4.int4_matmul_decode(x[:1].expand(257, 1, 256).contiguous(), qw)
    with pytest.raises(ValueError, match=r"x \[M, 1, D\]"):
        i4.int4_matmul_decode(torch.cat([x, x], dim=1), qw)
    with pytest.raises(ValueError, match="dtypes"):
        i4.int4_matmul_decode(x.half(), qw)
    x2, qw2 = _int4_inputs(cuda, "int4", 4, 64, 192, torch.bfloat16, 8)
    with pytest.raises(ValueError, match="contiguous"):
        i4.int4_matmul_decode(torch.cat([x2, x2], dim=-1)[..., ::2], qw2)
    x3, qw3 = _int4_inputs(cuda, "int4", 4, 64, 72, torch.bfloat16, 9)
    with pytest.raises(ValueError, match="multiple of 16"):
        i4.int4_matmul_decode(x3, qw3)


def test_flash_forward_bf16_at_a_left_padded_prefix(cuda):
    """The text engine's B = 1 prefix prefill: one row, H = 32, T = S = 1152,
    left-padded by 137 rows; valid rows within the forward's tolerances."""
    from ospo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(31)
    q, k, v = (torch.randn((1, 1152, 32, 128), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    mask = torch.ones((1, 1152), dtype=torch.int32, device=cuda)
    mask[0, :137] = 0
    out, l, m = fa.flash_attention(q, k, v, mask, return_stats=True)
    ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, mask)
    valid = mask[0] > 0
    torch.testing.assert_close(out[:, valid].float(), ref[:, valid].float(),
                               atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(l[..., valid], l_ref[..., valid], atol=0, rtol=1e-5)
    torch.testing.assert_close(m[..., valid], m_ref[..., valid], atol=1e-4, rtol=0)


@pytest.mark.parametrize("cur_len", [769, 896, 1024])
def test_decode_kernel_at_the_text_shape(cuda, cur_len):
    """The plain text program's cached steps: int8 cache, B = 64, the
    step-1 prompt bucket (768) + 256 rows."""
    from ospo_tpu_torch.ops import decode_attention as da

    L, S, H, B, dh = 2, 1024, 32, 64, 128
    g = torch.Generator(device=cuda).manual_seed(32)
    q = torch.randn((B, 1, H, dh), generator=g, device=cuda).bfloat16()
    kc, vc = (torch.randint(-127, 128, (L, S, H, B, dh), generator=g,
                            device=cuda, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((L, S, H, B), generator=g, device=cuda) * 0.02
              for _ in range(2))
    mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
    mask[:, :193] = 0
    out = da.decode_attention(q, kc, vc, 1, cur_len, mask, ks, vs)
    ref = da.decode_attention_plain(q, kc, vc, 1, cur_len, mask, ks, vs)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-4, rtol=2 ** -7)


@pytest.mark.parametrize("shared", [True, False])
def test_text_engine_greedy_on_the_card_matches_the_cpu(cuda, shared):
    """A small model (head dim 128, fp32, int8 KV) decoding greedily on the
    card (flash forward, decode kernel) and on the CPU (plain versions):
    identical ids for the shared-prefix and the plain programs."""
    import dataclasses

    from ospo_tpu_torch.engine.text_engine import TextGenEngine
    from ospo_tpu_torch.models import janus, llama
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(
        janus.tiny_janus_config(),
        language=llama.tiny_config(hidden_size=256, intermediate_size=512,
                                   num_heads=2))
    cpu = janus.JanusModel.init(cfg, seed=4, device="cpu", vision=False)

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda)

    gpu = janus.JanusModel(cfg, to_card(cpu.params), cuda)
    proc = Processor(ByteTokenizer(cfg.language.vocab_size))
    head = "Answer with a comma-separated list of things, as in the examples: "
    prompts = [head + "fruit", head + "animals in a park", head + "tools"]
    ids = [TextGenEngine(m, proc, max_new_tokens=12, do_sample=False,
                         kv_quant="int8", shared_prefix=shared).generate_ids(prompts)
           for m in (cpu, gpu)]
    assert (ids[0] == ids[1]).all()


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (5, 64, 128), (16, 256, 72),
                                   (17, 128, 64), (48, 4096, 11008),
                                   (100, 11008, 4096), (1000, 512, 256)])
def test_int8_product_on_the_card_is_exact(cuda, m, k, n):
    """The w8a8 product (``torch._int_mm``; M ≤ 16 padded with zero rows)
    equals the exact int64 product on the CPU, the 7B shapes included."""
    from ospo_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = quant.int8_matmul(a.to(cuda), w.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu().long(), a.long() @ w.long().T)


def test_int8_product_refuses_unaligned_widths_on_the_card(cuda):
    from ospo_tpu_torch.ops import quant

    a = torch.zeros((32, 60), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_matmul(a, torch.zeros((64, 60), dtype=torch.int8, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_linear_on_the_card_matches_the_cpu(cuda, dtype):
    """A w8a8 projection at T == 1 (M = 3, padded) and at T = 40 on the
    card against the CPU: the per-token scales equal (a quotient of two
    tensors, correctly rounded on both), the int8 activations equal but
    for rounding ties (≤ 1 step, on < 0.1% of them), and the result equals
    the exact int32 product of the card's activations, scaled as
    ``_w8a8_raw`` does, to 1e-6."""
    from ospo_tpu_torch.models import llama
    from ospo_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(3)
    qw = quant.quantize_matrix_w8a8(torch.randn((256, 128), generator=g))
    qw_card = {k: v.to(cuda) for k, v in qw.items()}
    for t in (1, 40):
        x = torch.randn((3, t, 128), generator=g).to(dtype)
        xq, sx = quant.quantize_activations_int8(x)
        xq_card, sx_card = (a.cpu() for a in quant.quantize_activations_int8(x.to(cuda)))
        assert torch.equal(sx_card, sx)
        diff = (xq_card.int() - xq.int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
        got = llama.linear(x.to(cuda), qw_card).cpu()
        exact = xq_card.reshape(-1, 128).long() @ qw["q"].long().T
        ref = (exact.view(3, t, 256).float() * sx_card * qw["sa"]).to(dtype)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(), atol=0, rtol=1e-6)


def test_int4n_decode_runs_the_row_kernel(cuda):
    """int4n weights (stored as the int4 row payload) at T == 1 launch the
    row kernel (kernel 5), within the int4 tolerances of its plain
    version."""
    from ospo_tpu_torch.models import llama
    from ospo_tpu_torch.ops import int4_matmul as i4
    from ospo_tpu_torch.ops import quant

    g = torch.Generator(device=cuda).manual_seed(8)
    w = torch.randn((4096, 4096), generator=g, device=cuda).bfloat16() * 0.02
    qw = quant.quant_fn("int4n")(w)
    x = torch.randn((48, 1, 4096), generator=g, device=cuda).bfloat16()
    n0 = kernel_launches()
    got = llama.linear(x, qw)
    torch.cuda.synchronize()
    assert _launched(n0, "int4_matmul_row") == (1,)
    _assert_int4_close(got, i4.int4_matmul_decode_plain(x, qw), "int4",
                       torch.bfloat16)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("S", [40, 704])
def test_decode_kernel_device_cur_len_equals_the_host_launch(cuda, S, kind):
    """cur_len in device memory (the grid sized for S, each block taking
    its part of the split of the length it reads) against the launch at the
    same host cur_len, bit for bit, at every cur_len in 1..S: a ragged row
    group, a left-padded row and a row whose every key is masked."""
    from ospo_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=cuda).manual_seed(S)
    L, H, B = 2, 4, 6
    q = torch.randn((B, 1, H, 128), generator=g, device=cuda).bfloat16()
    if kind == "int8":
        kc, vc = (torch.randint(-127, 128, (L, S, H, B, 128), generator=g,
                                device=cuda, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((L, S, H, B), generator=g, device=cuda) * 0.02
                  for _ in range(2))
    else:
        kc, vc = (torch.randn((L, S, H, B, 128), generator=g, device=cuda)
                  .bfloat16() for _ in range(2))
        ks = vs = None
    mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
    mask[0, :S // 3] = 0
    mask[B // 2] = 0
    lens = torch.arange(1, S + 1, dtype=torch.int32, device=cuda)
    n0 = kernel_launches()
    host = torch.stack([da.decode_attention(q, kc, vc, 1, n, mask, ks, vs)
                        for n in range(1, S + 1)])
    dev = torch.stack([da.decode_attention(q, kc, vc, 1, lens[n - 1:n], mask, ks, vs)
                       for n in range(1, S + 1)])
    torch.cuda.synchronize()
    assert _launched(n0, "decode_attention") == (2 * S,)
    bad = [n + 1 for n in range(S) if not torch.equal(host[n], dev[n])]
    assert not bad, f"cur_len {bad[:10]} differ"
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, kc, vc, 1, lens[:1].long(), mask, ks, vs)


def _graph_engines(model, proc, n_img, kv_quant):
    """The same engine twice: the trunk replayed as a CUDA graph, and the
    eager loop."""
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine

    kw = dict(image_token_num=n_img, img_size=16, patch_size=2, kv_quant=kv_quant)
    graph, eager = ImageGenEngine(model, proc, **kw), ImageGenEngine(model, proc, **kw)
    assert graph._replays_trunk()
    eager._replays_trunk = lambda: False
    return graph, eager


def _card_janus(cuda, cfg, quantize=False):
    from ospo_tpu_torch.models import janus
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import ByteTokenizer

    model = janus.JanusModel.init(cfg, seed=5, quantize=quantize, device=cuda,
                                  lm_head=False, understanding=False)
    return model, Processor(ByteTokenizer(cfg.language.vocab_size))


def _small_card_config(dtype):
    import dataclasses

    from ospo_tpu_torch.models import janus, llama

    return dataclasses.replace(
        janus.tiny_janus_config(dtype=dtype),
        language=llama.tiny_config(hidden_size=256, intermediate_size=512,
                                   num_heads=2, dtype=dtype))


def _seven_b_width_config(layers=2):
    import dataclasses

    from ospo_tpu_torch.models import janus, llama

    return dataclasses.replace(
        janus.JANUS_PRO_7B,
        language=dataclasses.replace(llama.LLAMA_7B, num_layers=layers))


GRAPH_PROMPTS = ["A red cube on top of a blue sphere", "Two cats",
                 "a lighthouse on a cliff at dusk, waves below, gulls overhead",
                 "three green apples"]


@pytest.mark.parametrize("case", ["small-fp32-int8kv", "small-bf16", "7b-int8",
                                  "7b-int4g"])
def test_forced_cfg_logits_replayed_equal_the_eager_loop(cuda, case):
    """The teacher-forced probe through the replayed trunk equals the eager
    loop's bit for bit: the small model (head dim 128) in fp32 with an int8
    cache and in bf16 with a bf16 cache, and the 7B widths at 2 layers on
    int8 and int4g weights with an int8 cache.  The first call captures,
    the second (a longer prompt bucket, so a larger cache) captures again,
    the third replays the kept graph throughout."""
    import numpy as np

    from ospo_tpu_torch.processing import t2i_prompt

    if case.startswith("small"):
        dtype = torch.float32 if "fp32" in case else torch.bfloat16
        model, proc = _card_janus(cuda, _small_card_config(dtype))
        kv, n_img = ("int8" if "int8kv" in case else False), 64
    else:
        model, proc = _card_janus(cuda, _seven_b_width_config(),
                                  quantize=case.split("-")[1])
        kv, n_img = "int8", 40
    graph, eager = _graph_engines(model, proc, n_img, kv)
    rng = np.random.default_rng(2)
    long = GRAPH_PROMPTS[2] + " " + "and more words " * 6
    for prompts in (GRAPH_PROMPTS, GRAPH_PROMPTS[:3] + [long], GRAPH_PROMPTS):
        prompts = [t2i_prompt(proc, p) for p in prompts]
        forced = rng.integers(0, model.cfg.image_token_size, (len(prompts), n_img))
        got = graph.forced_cfg_logits(prompts, forced)
        ref = eager.forced_cfg_logits(prompts, forced)
        assert got.shape == (len(prompts), n_img, model.cfg.image_token_size)
        assert np.array_equal(got, ref)
    assert graph._graph.graph is not None and eager._graph is None


def test_greedy_ids_replayed_equal_the_eager_loop(cuda):
    """Greedy ids (temperature 0) through the replayed trunk equal the
    eager loop's, at the 7B widths with 2 layers."""
    from ospo_tpu_torch.processing import t2i_prompt

    model, proc = _card_janus(cuda, _seven_b_width_config(), quantize="int8")
    graph, eager = _graph_engines(model, proc, 96, "int8")
    graph.temperature = eager.temperature = 0.0
    prompts = [t2i_prompt(proc, p) for p in GRAPH_PROMPTS]
    for seed in (0, 1):
        assert (graph.generate_tokens(prompts, seed=seed)
                == eager.generate_tokens(prompts, seed=seed)).all()


def test_a_replay_counts_the_launches_it_replays(cuda):
    """kernel_launches() after the probe through the replayed trunk: one
    flash launch a layer for the prefill and one decode launch a layer for
    each of the n_img - 1 cached steps, in the call that captures (its
    first step eager, the capture counting nothing) and in one that only
    replays; and the spans say which steps were replayed."""
    import time

    import numpy as np

    from ospo_tpu_torch.processing import t2i_prompt
    from ospo_tpu_torch.utils.profiling import spans

    model, proc = _card_janus(cuda, _small_card_config(torch.bfloat16))
    n_img, layers = 24, model.cfg.language.num_layers
    graph, _ = _graph_engines(model, proc, n_img, "int8")
    prompts = [t2i_prompt(proc, p) for p in GRAPH_PROMPTS[:2]]
    forced = np.zeros((2, n_img), np.int64)
    for replayed in (n_img - 2, n_img - 1):
        n0 = kernel_launches()
        t0 = time.perf_counter()
        graph.forced_cfg_logits(prompts, forced)
        got = spans(t0, time.perf_counter())
        n1 = kernel_launches()
        assert n1["decode_attention"] - n0["decode_attention"] == layers * (n_img - 1)
        assert n1["flash_fwd"] - n0["flash_fwd"] == layers
        trunk = [s.attrs["graph"] for s in got if s.name == "image.trunk"]
        assert len(trunk) == n_img - 1 and sum(trunk) == replayed
        captures = [s for s in got if s.name == "image.capture"]
        assert len(captures) == (replayed == n_img - 2)
        assert sum(s.name == "image.wait" for s in got) == replayed


# -- the weight-only int8 T == 1 kernel (ops/quant.py, csrc/w8a16_matmul.cu) --

W8A16_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008),      # 7B
                (2048, 2048), (5632, 2048), (2048, 5632),        # 1B
                (3072, 2048), (576, 2048), (10944, 2048), (2048, 10944)]  # MLA


def _w8a16_inputs(cuda, m, f, d, seed):
    from ospo_tpu_torch.ops import quant

    g = torch.Generator(device=cuda).manual_seed(seed)
    qw = quant.quantize_matrix(
        (torch.randn((f, d), generator=g, device=cuda) * 0.02).to(torch.bfloat16))
    x = torch.randn((m, 1, d), generator=g, device=cuda).to(torch.bfloat16)
    return x, qw


def _bf16_step(v):
    """The spacing of bf16 values at |v|: 2^(floor(log2 |v|) - 7)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


def _w8a16_plain(x, qw):
    """``_w8a16`` on the card, its bf16 GEMM summing in fp32 throughout."""
    from ospo_tpu_torch.ops import quant

    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return quant._w8a16(x, qw["q"], qw["s"])
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev


def _within_a_step(got, ref):
    """One bf16 step of |ref| plus 2^-8 max|ref|.  Both sides round the fp32
    sum to bf16, then the product by the bf16 row scale: where the two
    orders of the fp32 sums put the sum on either side of a rounding
    boundary, the first rounding moves one step, which the scale and the
    second rounding carry through; the absolute term covers outputs near
    zero, whose step is small against the sums' error."""
    r = ref.float()
    tol = _bf16_step(r) + 2 ** -8 * float(r.abs().max())
    return bool(((got.float() - r).abs() <= tol).all())


def _within_the_sum_order(got, x, qw):
    """The output is r(r(acc) r(s)) for an fp32 sum acc within 2^-17 sum
    |x q| of the exact sum (float64): only the order of the fp32 sums may
    differ from the plain function, so every output lies between the two
    roundings of that interval's ends.  Tighter than ``_within_a_step``
    wherever the sum is not at a rounding boundary."""
    q = qw["q"].double()
    acc = x[:, 0].double() @ q.T
    slack = 2.0 ** -17 * (x[:, 0].double().abs() @ q.abs().T)
    rs = qw["s"].to(torch.bfloat16).float()

    def finish(a):
        return (a.float().to(torch.bfloat16).float() * rs).to(torch.bfloat16).float()

    y = got[:, 0].float()
    return bool(((finish(acc - slack) <= y) & (y <= finish(acc + slack))).all())


@pytest.mark.parametrize("m", [1, 5, 48, 64])
@pytest.mark.parametrize("f,d", W8A16_SHAPES)
def test_w8a16_kernel_matches_plain(cuda, f, d, m):
    """The kernel against ``_w8a16`` on the card at the main paths' shapes
    (the 7B and 1B projections, the MLA layer's q, latent down-projection,
    dense FFN; F = 576 and K = 10944 are no multiples of the 128-row and
    128-column tiles) and 1, 5, 48 and 64 rows: within one bf16 step
    (``_within_a_step``), and within the rounding of the sum's order
    (``_within_the_sum_order``); one launch."""
    from ospo_tpu_torch.ops import quant

    x, qw = _w8a16_inputs(cuda, m, f, d, 20 + m)
    n0 = kernel_launches()
    got = quant.quantized_matmul(x, qw)
    assert _launched(n0, "w8a16_matmul") == (1,)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 1, f)
    assert _within_a_step(got, _w8a16_plain(x, qw))
    assert _within_the_sum_order(got, x, qw)


@pytest.mark.parametrize("f,d", [(11008, 4096), (5632, 2048), (576, 2048)])
def test_w8a16_kernel_controls_fail(cuda, f, d):
    """Two controls at 48 rows: the K chunk at the end dropped (x's last 128
    columns zeroed) fails both tolerances; one row's scale shifted by 1%
    (the row holding the largest output) fails the sum-order bound.  A 1%
    shift of a bf16 scale moves that row's outputs by 1 to 3 bf16 steps,
    which the one-step tolerance can hold near max|ref|: it is reported,
    not required, there."""
    from ospo_tpu_torch.ops import quant

    x, qw = _w8a16_inputs(cuda, 48, f, d, 30)
    ref = _w8a16_plain(x, qw)
    dropped = x.clone()
    dropped[..., -128:] = 0
    got = quant.quantized_matmul(dropped, qw)
    assert not _within_a_step(got, ref)
    assert not _within_the_sum_order(got, x, qw)
    row = int(ref.float().abs().amax(dim=(0, 1)).argmax())
    shifted = {"q": qw["q"], "s": qw["s"].clone()}
    shifted["s"][row] *= 1.01
    got = quant.quantized_matmul(x, shifted)
    assert not _within_the_sum_order(got, x, qw)


@pytest.mark.parametrize("m,fs,d", [(48, [4096, 4096, 4096], 4096),
                                    (48, [11008, 11008], 4096),
                                    (48, [3072, 576], 2048),
                                    (64, [4096], 11008), (5, [2048], 5632)])
def test_w8a16_kernel_is_deterministic_and_shares_launches(cuda, m, fs, d):
    """Two calls are bit-equal; matrices that share x in one launch give
    what separate launches with the same split of K give, bit for bit (a
    launch of its own may split K otherwise, which orders the fp32 sums
    otherwise)."""
    from ospo_tpu_torch.ops import quant

    x, _ = _w8a16_inputs(cuda, m, 16, d, 40)
    qws = [_w8a16_inputs(cuda, 1, f, d, 41 + i)[1] for i, f in enumerate(fs)]
    n0 = kernel_launches()
    a = quant.w8a16_matmul(x, qws)
    b = quant.w8a16_matmul(x, qws)
    assert _launched(n0, "w8a16_matmul") == (2,)
    n_split = quant.w8a16_split(m, fs, d)
    for y1, y2, qw in zip(a, b, qws):
        assert torch.equal(y1, y2)
        assert torch.equal(y1, quant.w8a16_matmul(x, [qw], n_split)[0])


def test_a_cached_step_runs_every_int8_projection_on_the_kernel(cuda):
    """The replayed trunk step of an int8 model launches the kernel four
    times a layer: q, k and v; o; gate and up; down."""
    import numpy as np

    from ospo_tpu_torch.processing import t2i_prompt

    model, proc = _card_janus(cuda, _small_card_config(torch.bfloat16), quantize="int8")
    n_img, layers = 24, model.cfg.language.num_layers
    graph, _ = _graph_engines(model, proc, n_img, "int8")
    prompts = [t2i_prompt(proc, p) for p in GRAPH_PROMPTS[:2]]
    forced = np.zeros((2, n_img), np.int64)
    graph.forced_cfg_logits(prompts, forced)   # captures
    n0 = kernel_launches()
    graph.forced_cfg_logits(prompts, forced)   # replays
    n1 = kernel_launches()
    assert n1["w8a16_matmul"] - n0["w8a16_matmul"] == 4 * layers * (n_img - 1)


# -- the suffix-attention kernel (step 4b's question suffixes) ---------------

SUFFIX_PREFIXES = [(0, None), (48, "shared"), (48, "per_image")]


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("C,pm", SUFFIX_PREFIXES)
@pytest.mark.parametrize("T", [16, 96, 304])
def test_suffix_kernel_matches_plain(cuda, T, C, pm, kind):
    """The kernel against the plain version at the 1B cell's shapes (16
    images, 16 heads, a window of 640 + T rows) on every row: left-padded
    image and suffix rows, image 1's first rows without an allowed key (the
    mean of V over prefix and window), rows past the window never read;
    within ``suffix_attention_reference``'s tolerance (the fp16 rounding of
    P, the bf16 output); one launch."""
    import suffix_attention_reference as sref

    from ospo_tpu_torch.ops import suffix_attention as sa

    a = sref.suffix_inputs(16, T, 16, 640, C, kind, seed=T + C, device=cuda,
                           prefix_mask=pm or "shared")
    n0 = kernel_launches()
    got = sref.call(sa.suffix_attention, a)
    assert _launched(n0, "suffix_attention") == (1,)
    ref, tol = sref.call(sref.plain_and_tolerance, a)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert sref.worst(got, ref, tol) <= 1.0


@pytest.mark.parametrize("C,pm", [(0, None), (48, "shared")])
def test_suffix_kernel_controls_fail(cuda, C, pm):
    """The tolerance refuses what a right kernel must not do, each by 10x
    or more: one image's k scales times 1 + 2^-7, the prefix dropped, the
    causal limit a row lower; the kernel itself stays within it."""
    import suffix_attention_reference as sref

    from ospo_tpu_torch.ops import suffix_attention as sa

    a = sref.suffix_inputs(16, 96, 16, 640, C, "int8", seed=11, device=cuda,
                           prefix_mask=pm or "shared")
    ref, tol = sref.call(sref.plain_and_tolerance, a)
    assert sref.worst(sref.call(sa.suffix_attention, a), ref, tol) <= 1.0
    for name, change in sref.controls(a).items():
        got = sref.call(sa.suffix_attention, a, **change)
        assert sref.worst(got, ref, tol) >= 10, name


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_suffix_kernel_is_deterministic(cuda, kind):
    import suffix_attention_reference as sref

    from ospo_tpu_torch.ops import suffix_attention as sa

    a = sref.suffix_inputs(16, 240, 16, 640, 48, kind, seed=5, device=cuda)
    assert torch.equal(sref.call(sa.suffix_attention, a), sref.call(sa.suffix_attention, a))


def test_suffix_kernel_in_a_scoring_call(cuda, monkeypatch):
    """A whole ``ScoringEngine`` call on a bf16 model with an int8 cache
    (the pre-image prefix, a budget of two images a slice, so two slices):
    its yes/no readouts equal the plain route's within 2^-5 relative, and
    the kernel runs once a layer and question pass of each slice (layers x
    Q_b x 2)."""
    import dataclasses

    import numpy as np

    from ospo_tpu_torch.engine.scoring import ScoringEngine
    from ospo_tpu_torch.image_processing import ImageProcessor
    from ospo_tpu_torch.models import janus, llama
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(
        janus.tiny_janus_config(dtype=torch.bfloat16),
        language=llama.tiny_config(hidden_size=256, intermediate_size=512,
                                   num_heads=2, dtype=torch.bfloat16))
    model = janus.JanusModel.init(cfg, seed=5, quantize="int8", device=cuda)
    proc = Processor(ByteTokenizer(cfg.language.vocab_size),
                     ImageProcessor(image_size=cfg.image_size),
                     num_image_tokens=cfg.num_image_tokens)
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (32, 32, 3)).astype(np.uint8) for _ in range(3)]
    questions = [["Is there a dog?", "Is it red?", "Does it match?"],
                 ["Is the sky blue?", "Does it match the prompt?"],
                 ["Is there a cat?", "Is it big?", "Is it outdoors?", "Does it match?"]]

    def score():
        eng = ScoringEngine(model, proc, kv_quant="int8")
        prep = eng.prepare_shared_multi(images, questions)
        eng.row_token_budget = 2 * prep.row_tokens
        return eng.score_images_multi(images, questions, prep=prep)

    n0 = kernel_launches()
    got = score()
    launches = _launched(n0, "suffix_attention")[0]
    monkeypatch.setattr(llama, "suffix_attention_takes", lambda *a, **k: False)
    ref = score()
    assert launches == cfg.language.num_layers * max(map(len, questions)) * 2
    ps = [(m[k], n[k]) for a, b in zip(got, ref)
          for m, n in zip(a["answer_metadata"], b["answer_metadata"]) for k in ("p_yes", "p_no")]
    assert len(ps) == 2 * 9
    assert max(abs(g - r) / abs(r) for g, r in ps) <= 2 ** -5


# ---------------------------------------------------------------------------
# the Gated DeltaNet decode kernel and the MoE routing at 512 experts
# (Qwen3-Next's widths: 16 key and 32 value heads of 128, conv of width 4)
# ---------------------------------------------------------------------------


def _gdn_inputs(cuda, rows, seed, hk=16, hv=32, d=128, K=4):
    """bf16 projections, weights drawn as the benchmark's (A_log the log of
    U(1, 16), dt_bias the inverse softplus of exp(U(log 1e-3, log 1e-1)),
    the conv N(0, 1/4), the gated norm's scale near 1), a bf16 conv state
    and an fp32 state of unit scale."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    C = 2 * hk * d + hv * d
    qkvz = torch.randn((rows, hk * (2 * d + 4 * d)), generator=g, device=cuda).bfloat16()
    ba = torch.randn((rows, hk * 4), generator=g, device=cuda).bfloat16()
    conv_w = (0.5 * torch.randn((C, K), generator=g, device=cuda)).bfloat16()
    conv_state = torch.randn((rows, K - 1, C), generator=g, device=cuda).bfloat16()
    state = torch.randn((rows, hv, d, d), generator=g, device=cuda)
    a_log = torch.log(1 + 15 * torch.rand((hv,), generator=g, device=cuda))
    dt = torch.exp(-6.9 + 4.6 * torch.rand((hv,), generator=g, device=cuda))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    norm_w = 1 + 0.1 * torch.randn((d,), generator=g, device=cuda)
    return qkvz, ba, conv_w, conv_state, state, a_log, dt_bias, norm_w


def test_gdn_decode_kernel_matches_plain(cuda):
    """One step at the cell's 192 rows: the kernel's output within a bf16
    rounding of the plain version's (the same fp32 math, sums in another
    order: 2^-7 relative plus 1e-3 of the scale), its states within fp32
    rounding (1e-5 relative plus 1e-6), its conv state bit-equal (a shift
    of bf16 values), in one launch; a repeat is bit-equal."""
    from ospo_tpu_torch.ops import gated_delta as gd

    qkvz, ba, conv_w, cs, st, a_log, dt_bias, norm_w = _gdn_inputs(cuda, 192, 0)
    args = (16, 128, 128, 2, 1e-6)
    cs_p, st_p = cs.clone(), st.clone()
    want = gd.decode_plain(qkvz, ba, conv_w, cs_p, st_p, a_log, dt_bias, norm_w, *args)
    outs = []
    for _ in range(2):
        cs_k, st_k = cs.clone(), st.clone()
        n0 = kernel_launches()
        outs.append(gd.decode(qkvz, ba, conv_w, cs_k, st_k, a_log, dt_bias, norm_w, *args))
        assert _launched(n0, "gdn_decode") == (1,)
    got = outs[0]
    assert torch.equal(outs[0], outs[1])
    err = (got.float() - want.float()).abs()
    assert (err <= 2 ** -7 * want.float().abs() + 1e-3 * want.float().abs().max()).all()
    assert torch.equal(cs_k, cs_p)
    torch.testing.assert_close(st_k, st_p, atol=1e-6, rtol=1e-5)


def _run_steps(step, qkvz_seq, ba, conv_w, cs, st, a_log, dt_bias, norm_w, bf16_state=False):
    for qkvz in qkvz_seq:
        step(qkvz, ba, conv_w, cs, st, a_log, dt_bias, norm_w, 16, 128, 128, 2, 1e-6)
        if bf16_state:
            st.copy_(st.bfloat16().float())
    return st


def test_gdn_state_after_576_steps_fails_a_bf16_state(cuda):
    """576 steps (an image's tokens) from a zero state through the kernel
    and through the plain fp32 step: the states agree to 1e-4 of their
    scale (fp32 rounding in another order, held down by the decay); the
    same steps with the state rounded to bf16 after each are far outside
    it, so a state kept in bf16 would fail."""
    from ospo_tpu_torch.ops import gated_delta as gd

    rows = 4
    _, ba, conv_w, cs, st, a_log, dt_bias, norm_w = _gdn_inputs(cuda, rows, 1)
    g = torch.Generator(device=cuda).manual_seed(2)
    seq = [torch.randn((rows, 16 * 768), generator=g, device=cuda).bfloat16()
           for _ in range(576)]
    st.zero_()
    cs.zero_()
    kern = _run_steps(gd.decode, seq, ba, conv_w, cs.clone(), st.clone(), a_log, dt_bias,
                      norm_w)
    plain = _run_steps(gd.decode_plain, seq, ba, conv_w, cs.clone(), st.clone(), a_log,
                       dt_bias, norm_w)
    low = _run_steps(gd.decode_plain, seq, ba, conv_w, cs.clone(), st.clone(), a_log,
                     dt_bias, norm_w, bf16_state=True)
    scale = plain.abs().max()
    tol = 1e-4 * scale
    assert (kern - plain).abs().max() <= tol
    assert (low - plain).abs().max() > 10 * tol


def test_moe_route_at_512_experts_top10(cuda):
    """``moe_route`` over 512 experts, top-10 renormalised, the shared
    gate's row after them (513 router rows, one more tile than a warp
    each): the experts of the plain routing but where scores tie to fp32
    rounding, weights within 1e-5, the shared slot's weight the gate's
    sigmoid within 1e-5; with a share of 64 experts from 64 on, the same
    routing with ids outside it -1 and those inside it shifted."""
    from ospo_tpu_torch.ops import moe

    E, D, k = 512, 2048, 10
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((192, D), generator=g, device=cuda).bfloat16()
    router = (torch.randn((E + 1, D), generator=g, device=cuda) * D ** -0.5).bfloat16()
    topi, topw = moe.route(x, router, k, True, 1.0, 1, shared_gate=True)
    differ, shortfall, w_err = moe.routing_gap(x, router[:E], topi, topw, k, norm_topk=True)
    assert differ <= 1 and shortfall <= 1e-6 and w_err <= 1e-5
    assert torch.equal(topi[:, k], torch.full_like(topi[:, k], E))
    gate = torch.sigmoid(x.float() @ router[E].float())
    assert (topw[:, k] - gate).abs().max() <= 1e-5
    ti, tw = moe.route(x, router, k, True, 1.0, 1, held=(64, 64), shared_gate=True)
    assert torch.equal(ti[:, :k], moe.held_ids(topi[:, :k], (64, 64)))
    assert torch.equal(ti[:, k], torch.full_like(ti[:, k], 64))
    assert torch.equal(tw, topw)


def test_moe_kernels_with_an_expert_share_match_the_plain_version(cuda):
    """The expert kernels on a share (64 of 512 held, top-10, one gated
    shared expert, D 2048, F 512) at a decode step's 192 rows, given the
    kernels' own routing: the same counts (absent slots make no grouped
    row), outputs within bf16 rounding of each stage."""
    from ospo_tpu_torch.ops import moe

    E, D, Fe, k, held = 512, 2048, 512, 10, (0, 64)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((192, D), generator=g, device=cuda).bfloat16()
    router = (torch.randn((E + 1, D), generator=g, device=cuda) * D ** -0.5).bfloat16()
    w13 = torch.randn((65, 2 * Fe, D), generator=g, device=cuda) * D ** -0.5
    w2 = torch.randn((65, D, Fe), generator=g, device=cuda) * Fe ** -0.5

    def q8(w):
        s = w.abs().amax(-1) / 127
        return {"q": torch.round(w / s[..., None]).to(torch.int8).contiguous(),
                "s": s.float().contiguous()}

    w13, w2 = q8(w13), q8(w2)
    counts = torch.zeros(65, dtype=torch.int32, device=cuda)
    got = moe.routed_experts(x, router, w13, w2, k, counts, True, 1.0, 1, held=held,
                             shared_gate=True)
    topi, topw = moe.route(x, router, k, True, 1.0, 1, held=held, shared_gate=True)
    bm = moe.block_m(topi.numel(), 65)
    c, offsets, src, te, ts = moe.align_plain(topi, 65, bm)
    assert torch.equal(counts, c) and int(c[64]) == 192
    h = moe.gate_up_plain(x, src, offsets, te, ts, w13, k + 1, bm)
    want = moe.combine_plain(moe.down_plain(h, src, offsets, te, ts, w2, bm), topw,
                             x.dtype).float()
    err = (got.float() - want).abs()
    assert (err <= 2 ** -7 * want.abs() + 1e-2 * want.abs().max()).all()


# ---------------------------------------------------------------------------
# the Kimi Delta Attention decode kernel and the sigmoid routing (Kimi
# Linear's widths: 32 heads of 128, conv of width 4, 256 experts top-8)
# ---------------------------------------------------------------------------


def _kda_inputs(cuda, rows, seed, heads=32, d=128, K=4):
    """bf16 projections (q, k, v, f, og of 32 heads of 128 and b), weights
    drawn as the benchmark's (A_log the log of U(1, 16), dt_bias a channel
    the inverse softplus of exp(U(log 1e-3, log 1e-1)), the conv N(0, 1/4),
    the norm's scale near 1), a bf16 conv state and an fp32 state of unit
    scale."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    width = heads * d
    proj = [torch.randn((rows, width), generator=g, device=cuda).bfloat16() for _ in range(5)]
    b = torch.randn((rows, heads), generator=g, device=cuda).bfloat16()
    conv_w = (0.5 * torch.randn((3 * width, K), generator=g, device=cuda)).bfloat16()
    conv_state = torch.randn((rows, K - 1, 3 * width), generator=g, device=cuda).bfloat16()
    state = torch.randn((rows, heads, d, d), generator=g, device=cuda)
    a_log = torch.log(1 + 15 * torch.rand((heads,), generator=g, device=cuda))
    dt = torch.exp(-6.9 + 4.6 * torch.rand((width,), generator=g, device=cuda))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    norm_w = 1 + 0.1 * torch.randn((d,), generator=g, device=cuda)
    q, k, v, f, og = proj
    return (q, k, v, f, b, og), conv_w, conv_state, state, a_log, dt_bias, norm_w


def test_kda_decode_kernel_matches_plain(cuda):
    """One step at the cell's 192 rows: the kernel's output within a bf16
    rounding of the plain version's (2^-7 relative plus 1e-3 of the scale),
    its states within fp32 rounding (1e-5 relative plus 1e-6), its conv
    state bit-equal, in one launch; a repeat is bit-equal; the inputs as
    slices of a prefill's ``[B, T, ·]`` projections (one row stride) give the
    same step; an odd head count raises."""
    from ospo_tpu_torch.ops import gated_delta as gd

    xs, conv_w, cs, st, a_log, dt_bias, norm_w = _kda_inputs(cuda, 192, 0)
    args = (a_log, dt_bias, norm_w, 32, 1e-5)
    cs_p, st_p = cs.clone(), st.clone()
    want = gd.kda_decode_plain(*xs, conv_w, cs_p, st_p, *args)
    outs = []
    for _ in range(2):
        cs_k, st_k = cs.clone(), st.clone()
        n0 = kernel_launches()
        outs.append(gd.kda_decode(*xs, conv_w, cs_k, st_k, *args))
        assert _launched(n0, "kda_decode") == (1,)
    got = outs[0]
    assert torch.equal(outs[0], outs[1])
    err = (got.float() - want.float()).abs()
    assert (err <= 2 ** -7 * want.float().abs() + 1e-3 * want.float().abs().max()).all()
    assert torch.equal(cs_k, cs_p)
    torch.testing.assert_close(st_k, st_p, atol=1e-6, rtol=1e-5)
    # a prefill's slices: [B, 3, ·] tensors read at position 1
    wide = [torch.stack([torch.zeros_like(t), t, torch.zeros_like(t)], 1) for t in xs]
    cs_s, st_s = cs.clone(), st.clone()
    sliced = gd.kda_decode(*(t[:, 1] for t in wide), conv_w, cs_s, st_s, *args)
    assert torch.equal(sliced, got) and torch.equal(st_s, st_k)
    with pytest.raises(ValueError, match="kda_decode"):
        gd.kda_decode(*(t[:, :31 * 128] if t.shape[1] == 4096 else t[:, :31] for t in xs),
                      conv_w[:93 * 128], cs[..., :93 * 128].contiguous(), st[:, :31].contiguous(),
                      a_log[:31], dt_bias[:31 * 128], norm_w, 31, 1e-5)


def test_kda_state_after_576_steps_fails_a_bf16_state_and_a_scalar_decay(cuda):
    """576 steps (an image's tokens) from a zero state through the kernel
    and through the plain fp32 step: the states agree to 1e-4 of their
    scale; the same steps with the state rounded to bf16 after each, and
    with each head's decay the mean of its per-channel one (a GDN's
    arithmetic), are far outside it."""
    from ospo_tpu_torch.ops import gated_delta as gd

    rows = 4
    xs, conv_w, cs, st, a_log, dt_bias, norm_w = _kda_inputs(cuda, rows, 1)
    g = torch.Generator(device=cuda).manual_seed(2)
    seqs = [[torch.randn(t.shape, generator=g, device=cuda).bfloat16() for t in xs]
            for _ in range(576)]
    st.zero_()
    cs.zero_()

    def run(step, bf16_state=False, scalar=False):
        c, s = cs.clone(), st.clone()
        for q, k, v, f, b, og in seqs:
            if scalar:   # f + dt_bias whose softplus is one value a head
                fh = torch.nn.functional.softplus(f.float().view(rows, 32, 128)
                                                  + dt_bias.view(32, 128))
                sp = fh.mean(-1, keepdim=True).expand_as(fh)
                f = (sp + torch.log(-torch.expm1(-sp)) - dt_bias.view(32, 128)).view(rows, -1)
                f = f.bfloat16()
            step(q, k, v, f, b, og, conv_w, c, s, a_log, dt_bias, norm_w, 32, 1e-5)
            if bf16_state:
                s.copy_(s.bfloat16().float())
        return s

    kern, plain = run(gd.kda_decode), run(gd.kda_decode_plain)
    tol = 1e-4 * plain.abs().max()
    assert (kern - plain).abs().max() <= tol
    assert (run(gd.kda_decode_plain, bf16_state=True) - plain).abs().max() > 10 * tol
    assert (run(gd.kda_decode_plain, scalar=True) - plain).abs().max() > 10 * tol


def test_moe_route_sigmoid_with_a_correction_bias(cuda):
    """``moe_route``'s sigmoid mode over 256 experts, top-8 renormalised
    over (Σ + 1e-20) and times 2.446, with a correction bias that moves
    some tokens' experts, against ``route_plain``: the same experts but
    where the choice scores tie to fp32 rounding, the weights the unbiased
    sigmoids within 1e-5; with a share of 64 experts, the same routing with
    ids outside it -1; the softmax mode of the same launch site unchanged."""
    from ospo_tpu_torch.ops import moe

    E, D, k, scale = 256, 2304, 8, 2.446
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((192, D), generator=g, device=cuda).bfloat16()
    router = (torch.randn((E, D), generator=g, device=cuda) * D ** -0.5).bfloat16()
    bias = 0.05 * torch.randn((E,), generator=g, device=cuda)
    topi, topw = moe.route(x, router, k, True, scale, 1, score_bias=bias)
    differ, shortfall, w_err = moe.routing_gap(x, router, topi, topw, k, True, scale, bias)
    assert differ <= 1 and shortfall <= 1e-6 and w_err <= 1e-5
    plain_i, _ = moe.route_plain(x, router, k, True, scale)
    moved = (topi[:, :k].sort(1).values != plain_i.sort(1).values).any(1)
    assert int(moved.sum()) > 0
    assert torch.equal(topi[:, k], torch.full_like(topi[:, k], E))
    assert torch.equal(topw[:, k], torch.ones_like(topw[:, k]))
    ti, tw = moe.route(x, router, k, True, scale, 1, held=(0, 64), score_bias=bias)
    assert torch.equal(ti[:, :k], moe.held_ids(topi[:, :k], (0, 64)))
    assert torch.equal(tw, topw)
    si, sw = moe.route(x, router, k, True, scale)
    assert moe.routing_gap(x, router, si, sw, k, True, scale)[0] <= 1


# -- the layer tail (ops/layer_tail.py, csrc/layer_tail.cu) --------------------

# (B, T, heads, hidden, ffn): the 7B and 1B decode steps (48 rows, a device
# position) and step 4b's question suffixes at both widths (a host start)
TAIL_SHAPES = [(48, 1, 32, 4096, 11008), (48, 1, 16, 2048, 5632),
               (8, 96, 32, 4096, 11008), (8, 96, 16, 2048, 5632)]


def _norm_ties(got, ref):
    """(fraction of elements that differ, whether each lies within the tie
    of the normalised value): the norm's sum of squares runs in another
    order, so its fp32 statistic can differ by an ulp and move the rounding
    of x · rms across a boundary, one bf16 step of that value; times the
    weight and rounded again, that step is less than two steps of the
    output (the product's binade is at most one above the step's), so
    each output lies within two bf16 steps of the larger of the two."""
    g, r = got.float(), ref.float()
    step = _bf16_step(torch.maximum(g.abs(), r.abs()))
    return float((g != r).float().mean()), bool(((g - r).abs() <= 2 * step).all())


@pytest.mark.parametrize("add", [True, False])
@pytest.mark.parametrize("B,T,H,D,F", TAIL_SHAPES)
def test_add_rms_norm_kernel_matches_plain(cuda, B, T, H, D, F, add):
    """The residual sum bit-equal; the normed output within the tie of the
    normalised value (``_norm_ties``) on at most 0.1% of its elements, the
    rest bit-equal."""
    from ospo_tpu_torch.ops import layer_tail

    g = torch.Generator(device=cuda).manual_seed(D + T)
    x = (torch.randn((B, T, D), generator=g, device=cuda) * 3).bfloat16()
    y = torch.randn((B, T, D), generator=g, device=cuda).bfloat16() if add else None
    w = (1 + 0.3 * torch.randn(D, generator=g, device=cuda)).bfloat16()
    n0 = kernel_launches()
    got_x, got_h = layer_tail.add_rms_norm(x, y, w, 1e-6)
    want_x, want_h = layer_tail.add_rms_norm_plain(x, y, w, 1e-6)
    torch.cuda.synchronize()
    assert _launched(n0, "add_rms_norm") == (1,)
    assert torch.equal(got_x, want_x)
    share, within = _norm_ties(got_h, want_h)
    assert within and share <= 1e-3, share


def _tail_qkv(cuda, B, T, H, seed):
    """q, k and v as views of one fused projection output [B, T, 3·H·128]."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = (torch.randn((B, T, 3 * H * 128), generator=g, device=cuda) * 2).bfloat16()
    return [t.view(B, T, H, 128) for t in qkv.split(H * 128, dim=-1)], g


@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("B,T,H,D,F", TAIL_SHAPES)
def test_rope_kv_write_kernel_matches_plain(cuda, B, T, H, D, F, kv):
    """Rope on q and k and the cache write, from the fused projection's
    views: roped q and k, every cache payload and scale (untouched rows
    included) bit-equal to the plain form; T = 1 at a device position, T >
    1 at a host start after 640 image rows."""
    from ospo_tpu_torch.models import llama
    from ospo_tpu_torch.ops import layer_tail

    (q, k, v), g = _tail_qkv(cuda, B, T, H, D + T)
    start = 640 if T > 1 else 301
    S = start + T + 8
    pos = start + torch.arange(T, device=cuda)[None].expand(B, T) \
        - torch.randint(0, 20, (B, 1), generator=g, device=cuda)
    cfg = llama.LlamaConfig(hidden_size=D, num_heads=H, intermediate_size=F)
    cos, sin = llama.rope_frequencies(cfg, pos)
    at = torch.tensor([start], device=cuda) if T == 1 else start

    def cache():
        if kv == "int8":
            c = {n: torch.randint(-127, 128, (2, S, H, B, 128), generator=g, device=cuda,
                                  dtype=torch.int8) for n in ("k", "v")}
            c.update({n: torch.rand((2, S, H, B), generator=g, device=cuda)
                      for n in ("k_s", "v_s")})
        else:
            c = {n: torch.randn((2, S, H, B, 128), generator=g, device=cuda).bfloat16()
                 for n in ("k", "v")}
        return c

    got_c = cache()
    want_c = {n: t.clone() for n, t in got_c.items()}
    n0 = kernel_launches()
    got = layer_tail.rope_kv_write(q, k, v, cos, sin, got_c, 1, at, roped_k=True)
    want = layer_tail.rope_kv_write_plain(q, k, v, cos, sin, want_c, 1, at, roped_k=True)
    torch.cuda.synchronize()
    assert _launched(n0, "rope_kv_write") == (1,)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name in want_c:
        assert torch.equal(got_c[name], want_c[name]), name


@pytest.mark.parametrize("B,T,H,D,F", TAIL_SHAPES)
def test_silu_mul_kernel_matches_plain(cuda, B, T, H, D, F):
    from ospo_tpu_torch.ops import layer_tail

    g = torch.Generator(device=cuda).manual_seed(F + T)
    gate, up = ((torch.randn((B, T, F), generator=g, device=cuda) * 4).bfloat16()
                for _ in range(2))
    n0 = kernel_launches()
    got = layer_tail.silu_mul(gate, up)
    torch.cuda.synchronize()
    assert _launched(n0, "silu_mul") == (1,)
    assert torch.equal(got, layer_tail.silu_mul_plain(gate, up))


def test_tail_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from ospo_tpu_torch.ops import layer_tail

    x = torch.zeros((4, 1, 256), device=cuda, dtype=torch.bfloat16)
    w = torch.ones(256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        layer_tail.add_rms_norm(x.float(), None, w, 1e-6)
    buf = torch.zeros(4 * 256 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        layer_tail.add_rms_norm(buf[1:].view(4, 1, 256), None, w, 1e-6)
    (q, k, v), _ = _tail_qkv(cuda, 2, 1, 2, 0)
    cos = sin = torch.zeros((2, 1, 64), device=cuda)
    c = {n: torch.zeros((1, 8, 2, 2, 128), device=cuda, dtype=torch.int8) for n in "kv"}
    c.update({n + "_s": torch.zeros((1, 8, 2, 2), device=cuda) for n in "kv"})
    with pytest.raises(ValueError, match="int64"):
        layer_tail.rope_kv_write(q, k, v, cos, sin, c, 0,
                                 torch.tensor([3], device=cuda, dtype=torch.int32))
    with pytest.raises(ValueError, match="positions"):
        layer_tail.rope_kv_write(q, k, v, cos, sin, c, 0, 8)
    with pytest.raises(ValueError, match="int8 rows"):
        layer_tail.rope_kv_write(q, k, v, cos, sin, {**c, "k_s": c["k_s"].half()}, 0, 3)
    with pytest.raises(ValueError, match="bfloat16"):
        layer_tail.silu_mul(x, x.float())


def test_a_1b_decode_step_on_the_tail_route_against_the_plain_route(cuda, monkeypatch):
    """The 1B trunk (24 layers, int8 weights, norms not all ones, int8
    cache, 48 rows): a prefill and three T = 1 steps at a device length,
    through the kernels and through the plain ops (``takes`` refused) with
    the norm kernel in place of ``rms_norm``: hidden states and every cache
    tensor bit-equal, so the routes differ by the norm's sum order alone.
    (Against the plain norm, those ties grow over 24 layers of random
    weights to ~1% of the hidden states' RMS.)"""
    from ospo_tpu_torch.models import janus, llama
    from ospo_tpu_torch.ops import layer_tail

    cfg = llama.LLAMA_1B
    params = janus._init_language(janus._Init(5, cuda), cfg, "int8")
    g = torch.Generator(device=cuda).manual_seed(6)
    for holder, name in ((params["layers"], "attn_norm"), (params["layers"], "mlp_norm"),
                         (params, "final_norm")):
        w = holder[name]
        holder[name] = (1 + 0.3 * torch.randn(w.shape, generator=g, device=cuda)).bfloat16()
    B, T, S = 48, 40, 64
    xs = [(torch.randn((B, n, cfg.hidden_size), generator=g, device=cuda) * 0.5).bfloat16()
          for n in (T, 1, 1, 1)]
    mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
    mask[:, :5] = 0
    prompt_mask = mask[:, :T].contiguous()
    pos = llama.positions_from_mask(prompt_mask)
    real = layer_tail.takes

    def run(take):
        monkeypatch.setattr(layer_tail, "takes", real if take else lambda *a: False)
        n0 = kernel_launches()
        cache = llama.init_kv_cache(cfg, B, S, quantized="int8", device=cuda)
        outs = [llama.forward(params, cfg, xs[0], prompt_mask, pos, kv_cache=cache,
                              self_attn=True)[0]]
        cache["length"] = torch.tensor([T], dtype=torch.int32, device=cuda)
        for i, x in enumerate(xs[1:]):
            outs.append(llama.forward(params, cfg, x, mask, pos[:, -1:] + 1 + i,
                                      kv_cache=cache)[0])
        torch.cuda.synchronize()
        return outs, cache, _launched(n0, "add_rms_norm", "rope_kv_write", "silu_mul")

    got, got_c, n_tail = run(True)
    monkeypatch.setattr(layer_tail, "rms_norm",
                        lambda x, w, eps: layer_tail.add_rms_norm(x, None, w, eps)[1])
    want, want_c, n_plain = run(False)
    L = cfg.num_layers
    assert n_tail == (4 * (2 * L + 1), 4 * L, 4 * L)
    assert n_plain == (4 * (2 * L + 1), 0, 0)   # the swapped-in norms alone
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    for name in ("k", "v", "k_s", "v_s"):
        assert torch.equal(got_c[name], want_c[name]), name


def test_a_replayed_step_launches_the_tail_kernels(cuda):
    """The replayed trunk step of a bf16 model over an int8 cache runs two
    norms a layer plus the final one, one rope and one SiLU·up a layer, and
    so does the eager prefill: n_img forwards a call."""
    import numpy as np

    from ospo_tpu_torch.processing import t2i_prompt

    model, proc = _card_janus(cuda, _small_card_config(torch.bfloat16), quantize="int8")
    n_img, layers = 24, model.cfg.language.num_layers
    graph, _ = _graph_engines(model, proc, n_img, "int8")
    prompts = [t2i_prompt(proc, p) for p in GRAPH_PROMPTS[:2]]
    forced = np.zeros((2, n_img), np.int64)
    graph.forced_cfg_logits(prompts, forced)   # captures
    n0 = kernel_launches()
    graph.forced_cfg_logits(prompts, forced)   # replays
    assert _launched(n0, "add_rms_norm", "rope_kv_write", "silu_mul") == (
        (2 * layers + 1) * n_img, layers * n_img, layers * n_img)
