"""Written-out references for the checks of the flash forward's bf16 kernel
(``ospo_tpu_torch/ops/csrc/flash_fwd.cu``).

The port's plain forward (``flash_attention_plain``) keeps p in fp32, as the
TPU kernel does.  The kernel's bf16 body rounds p to bf16 as the A operand
of ``P . V`` (FlashAttention-2's scheme); m and l take the fp32 p.  Here:

- :func:`forward`: the plain forward's function from the unscaled scores
  ``q . k`` times ``D^-0.5`` (the kernel's order), with p optionally rounded
  to bf16 before ``P . V`` (the kernel's scheme, emulated) and, for control
  runs, the raw scores rounded to bf16 as well (a kernel that loses more
  than its scheme does);
- :func:`exact_forward`: a float64 forward;
- :func:`budget`: the RMS error of a forward's O against
  :func:`exact_forward` beside that of the plain forward; the rule is "at
  most ``BUDGET`` times", on inputs from :func:`budget_case` (q scaled by
  ``Q_SCALE``), as for the backward (``flash_bwd_reference``).

Used by ``tests/test_torch_ops.py``, ``tests/test_torch_cuda.py``,
``chip_smoke.py`` and ``scripts/flash_bwd_budget_control.py``; it imports
torch and the port only.
"""

import torch

from flash_bwd_reference import BUDGET, Q_SCALE, _rms, _repeat_heads
from ospo_tpu_torch.ops import flash_attention as fa

__all__ = ["BUDGET", "Q_SCALE", "forward", "exact_forward", "budget_case",
           "budget"]


def _window(s, causal):
    """``s [B, H, T, S]`` with the keys past the causal window at -inf."""
    if causal:
        T, S = s.shape[-2:]
        rows = torch.arange(T, device=s.device)[:, None]
        cols = torch.arange(S, device=s.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
    return s


def forward(q, k, v, mask, causal=True, round_p=False, round_s=False):
    """fp32 (O, l, m) of the port's attention: scores ``(q . k) * D^-0.5``
    (``round_s`` rounds ``q . k`` to bf16 first), masked keys -1e30, keys
    past the window excluded, ``l`` the sum of the fp32 p; ``round_p``
    rounds p to bf16 before ``P . V``.  O is normalised by
    ``max(l, 1e-30)`` and left in fp32."""
    D, H = q.shape[-1], q.shape[2]
    kf, vf = _repeat_heads(k.float(), H), _repeat_heads(v.float(), H)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf)
    if round_s:
        s = s.to(torch.bfloat16).float()
    s = s * D ** -0.5
    s = torch.where(mask[:, None, None, :] > 0, s, torch.full_like(s, -1e30))
    s = _window(s, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if round_p:
        p = p.to(torch.bfloat16).float()
    o = torch.einsum("bhts,bshd->bthd", p, vf)
    return o / l.clamp_min(1e-30).transpose(1, 2)[..., None], l, m


def exact_forward(q, k, v, mask, causal=True):
    """float64 O of the port's attention (a softmax over the window, masked
    keys scoring -1e30)."""
    D, H = q.shape[-1], q.shape[2]
    kd, vd = _repeat_heads(k.double(), H), _repeat_heads(v.double(), H)
    s = torch.einsum("bthd,bshd->bhts", q.double(), kd) * D ** -0.5
    s = torch.where(mask[:, None, None, :] > 0, s, torch.full_like(s, -1e30))
    p = torch.softmax(_window(s, causal), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, vd)


def budget_case(q, k, v, mask):
    """The budget's arguments from bf16 draws: (q * Q_SCALE, k, v, mask)."""
    return q * Q_SCALE, k, v, mask


def budget(got, q, k, v, mask, causal=True):
    """(RMS error of ``got``, RMS error of the plain forward's O), both
    against :func:`exact_forward`; ``got`` is a forward's O from the same
    arguments, in their dtype."""
    plain = fa.flash_attention_plain(q, k, v, mask, causal)[0]
    exact = exact_forward(q, k, v, mask, causal)
    return _rms(got, exact), _rms(plain, exact)
