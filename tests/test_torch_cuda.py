"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present and run on the
card with ``python -m pytest tests/test_torch_cuda.py -q``.  ``chip_smoke.py``
makes the same comparisons at the main path's full shapes.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


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
    n0 = fa.launches
    out, l, m = fa.flash_attention(q, k, v, mask, causal=causal,
                                   return_stats=True)
    ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, mask, causal=causal)
    assert fa.launches == n0 + 1
    # fp32 math on both sides; a bf16 output differs by its final rounding
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(l, l_ref, atol=0, rtol=1e-5)
    torch.testing.assert_close(m, m_ref, atol=1e-4, rtol=0)


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
    n0 = (fa.dq_launches, fa.dkv_launches)
    dq = fa.flash_dq(q, k, v, mask, do, m, l, di, causal)
    dk, dv = fa.flash_dkv(q, k, v, mask, do, m, l, di, causal)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (n0[0] + 1, n0[1] + 1)
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
    n0 = (fa.launches, fa.dq_launches, fa.dkv_launches)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = tattn.attention(*leaves, mask=mask, impl="flash")
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == \
        (n0[0] + 1, n0[1] + 1, n0[2] + 1)
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
    n0 = (fa.launches, fa.dq_launches, fa.dkv_launches)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = tattn.attention(*leaves, mask=mask, impl="flash")
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == \
        (n0[0] + 1, n0[1] + 1, n0[2] + 1)
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


def _int4_inputs(cuda, mode, m, f, d, dtype, seed):
    from ospo_tpu_torch.ops import quant

    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((f, d), generator=g, device=cuda) * 0.05
    w[:, :3] *= 8.0                      # outlier columns: row and group differ
    qw = quant.quant_fn(mode)(w.to(dtype))
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
    n0 = i4.group_launches if mode == "int4g" else i4.row_launches
    got = i4.int4_matmul_decode(x, qw)
    ref = i4.int4_matmul_decode_plain(x, qw)
    torch.cuda.synchronize()
    assert (i4.group_launches if mode == "int4g" else i4.row_launches) == n0 + 1
    assert got.dtype == dtype and got.shape == (m, 1, f)
    scale = float(ref.float().abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-3 * scale,
                                   rtol=2 ** -6 if mode == "int4" else 2 ** -7)


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
            n0 = (i4.row_launches, i4.group_launches)
            got = llama.linear(x, qw)
            torch.cuda.synchronize()
            moved = (i4.row_launches - n0[0], i4.group_launches - n0[1])
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
