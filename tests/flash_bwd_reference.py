"""Written-out references for the checks of the flash backward's bf16 kernels
(``ospo_tpu_torch/ops/csrc/flash_bwd_dq.cu`` and ``flash_bwd_dkv.cu``).

The port's plain backward (``flash_dq_plain``, ``flash_dkv_plain``) keeps p
and ds in fp32, as the TPU kernels do.  The kernels' bf16 bodies round p and
ds to bf16 before their second products (FlashAttention-2's scheme).  Here:

- :func:`backward`: the plain backward's formulas from the forward's m, l
  and di, with p and ds optionally rounded to bf16 (the kernels' scheme,
  emulated) and, for control runs, the raw scores rounded to bf16 as well (a
  kernel that loses more than its scheme does);
- :func:`exact_backward`: a float64 backward from its own float64 forward;
- :func:`budget`: the RMS error of a backward against :func:`exact_backward`
  beside that of the plain backward; the rule is "at most ``BUDGET`` times".
  The RMS over a tensor is used, not its max: the max of one tensor moves by
  tens of percent with the seed, the RMS by a few.

Used by ``tests/test_torch_ops.py``, ``tests/test_torch_cuda.py``,
``chip_smoke.py`` and ``scripts/flash_bwd_budget_control.py``; it imports
torch and the port only.
"""

import torch

from ospo_tpu_torch.ops import flash_attention as fa

BUDGET = 2.0
# The budget's inputs scale q by this: scores of standard deviation ~2, as
# peaked as a trained model's attention, where a kernel that rounds the
# scores to bf16 shows (at 1 its RMS error is only ~2x the plain one's).
Q_SCALE = 2.0


def _rounded(x):
    return x.to(torch.bfloat16).float()


def _repeat_heads(x, h):
    """k or v ``[B, S, KVH, D]`` with each head repeated for its query heads."""
    return x if x.shape[2] == h else x.repeat_interleave(h // x.shape[2], dim=2)


def _sum_groups(x, kvh):
    """``[B, S, H, D]`` → ``[B, S, KVH, D]``, each group of query heads summed."""
    B, S, H, D = x.shape
    return x if H == kvh else x.reshape(B, S, kvh, H // kvh, D).sum(dim=3)


def backward(q, k, v, mask, do, m, l, di, causal=True, round_p_ds=False,
             round_s=False):
    """fp32 (dq, dk, dv) from the forward's m, l and di, GQA summed in fp32.
    With neither rounding these are the plain backward's operations, in its
    order; ``round_p_ds`` rounds p and ds to bf16 before the second products
    (ds from the unrounded p, the scale inside ds); ``round_s`` rounds the
    unscaled scores ``q . k`` to bf16."""
    B, T, H, D = q.shape
    S, kvh = k.shape[1], k.shape[2]
    kf, vf = _repeat_heads(k.float(), H), _repeat_heads(v.float(), H)
    qf, dof = q.float(), do.float()
    if round_s:
        s = _rounded(torch.einsum("bthd,bshd->bhts", qf, kf)) * D ** -0.5
    else:
        s = torch.einsum("bthd,bshd->bhts", qf * D ** -0.5, kf)
    s = torch.where(mask[:, None, None, :] > 0, s, torch.full_like(s, -1e30))
    p = torch.exp(s - m[..., None]) / l.clamp_min(1e-30)[..., None]
    if causal:
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        p = p.masked_fill(cols > rows, 0.0)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - di[..., None]) * D ** -0.5
    if round_p_ds:
        p, ds = _rounded(p), _rounded(ds)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    return dq, _sum_groups(dk, kvh), _sum_groups(dv, kvh)


def exact_backward(q, k, v, mask, do, causal=True):
    """float64 (dq, dk, dv) of the port's attention from its own float64
    forward (a softmax over the window, masked keys scoring -1e30)."""
    B, T, H, D = q.shape
    S, kvh = k.shape[1], k.shape[2]
    q, do = q.double(), do.double()
    k, v = _repeat_heads(k.double(), H), _repeat_heads(v.double(), H)
    s = torch.einsum("bthd,bshd->bhts", q, k) * D ** -0.5
    s = torch.where(mask[:, None, None, :] > 0, s, torch.full_like(s, -1e30))
    if causal:
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    o = torch.einsum("bhts,bshd->bthd", p, v)
    di = (o * do).sum(dim=-1).transpose(1, 2)
    dp = torch.einsum("bthd,bshd->bhts", do, v)
    ds = p * (dp - di[..., None]) * D ** -0.5
    del dp
    dq = torch.einsum("bhts,bshd->bthd", ds, k)
    dk = torch.einsum("bhts,bthd->bshd", ds, q)
    dv = torch.einsum("bhts,bthd->bshd", p, do)
    return dq, _sum_groups(dk, kvh), _sum_groups(dv, kvh)


def budget_case(q, k, v, mask, do, causal=True):
    """The budget's arguments from bf16 draws: (q * Q_SCALE, k, v, mask, do,
    m, l, di), the statistics from the plain forward."""
    q = q * Q_SCALE
    o, l, m = fa.flash_attention_plain(q, k, v, mask, causal)
    return q, k, v, mask, do, m, l, fa.row_dot(o, do)


def _rms(a, ref):
    return float((a.double() - ref).pow(2).mean().sqrt())


def budget(got, q, k, v, mask, do, m, l, di, causal=True):
    """[(name, RMS error of ``got``, RMS error of the plain backward)] for
    dq, dk and dv, both against :func:`exact_backward`; ``got`` is a
    backward from the same arguments, in their dtype."""
    args = (q, k, v, mask, do, m, l, di, causal)
    plain = (fa.flash_dq_plain(*args), *fa.flash_dkv_plain(*args))
    exact = exact_backward(q, k, v, mask, do, causal)
    return [(name, _rms(a, r), _rms(b, r))
            for name, a, b, r in zip(("dq", "dk", "dv"), got, plain, exact)]
