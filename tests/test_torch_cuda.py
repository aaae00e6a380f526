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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,h,kvh,causal", [(128, 4, 4, True),
                                            (77, 4, 2, True),
                                            (150, 6, 2, False)])
def test_flash_backward_kernels_match_plain(cuda, dtype, t, h, kvh, causal):
    """dQ and dK/dV kernels against their plain versions on the same
    inputs and forward statistics: T a tile multiple and ragged, GQA, a
    masked key.  fp32 inside both; fp32 outputs within 1e-4 (summation
    order), bf16 outputs within one bf16 step (1e-4 + 2^-7 |ref|)."""
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
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-4, 2 ** -7)
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                           ("dv", dv, ref_dv)):
        assert got.dtype == dtype and got.shape == ref.shape, name
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol, msg=name)


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
