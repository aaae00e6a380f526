"""The gated delta rule of a Gated DeltaNet (GDN) layer (Qwen3-Next's linear
attention) and of a Kimi Delta Attention (KDA) layer (Kimi Linear's): each
T = 1 decode step as one hand-written CUDA kernel (``csrc/gated_delta.cu``:
``gdn_decode``, ``kda_decode``) and its plain PyTorch version; the chunked
plain form a GDN prefill runs, and the KDA prefill as its steps in turn.

No TPU kernel of the JAX package has this function: the JAX package runs
no linear-attention trunk.  The step's work is the recurrent state, a
``[Dk, Dv]`` fp32 matrix a value head and row (``[rows, Hv, 128, 128]`` a
layer, 64 KiB a head): each step reads it once and writes it once, so a
decode step is bound by those bytes, and the kernel does everything
between the layer's input projections and its output projection in one
pass over them.

Semantics, shared by the kernel and the plain versions, for one row and
layer (``r()`` rounds to the model dtype):

- inputs: the projections ``qkvz`` (per key head h, in order: q ``Dk``, k
  ``Dk``, v ``r·Dv``, z ``r·Dv``, with ``r = Hv / Hk`` value heads a key
  head) and ``ba`` (per key head: b ``r``, a ``r``), as
  ``fix_query_key_value_ordering`` splits them;
- a causal depthwise conv of width K over the C channels ``[q ‖ k ‖ v]``
  (all key heads' q, then k, then the value heads' v) in fp32: ``c_t =
  Σ_j w[:, j] · x_{t-K+1+j}``, the K - 1 previous inputs kept in the conv
  state (model dtype, which holds the bf16 inputs exactly), then SiLU;
- q and k L2-normalised per key head (``x · rsqrt(Σx² + 1e-6)``), q times
  ``Dk^-½``; key head h serves value heads ``r·h .. r·h + r - 1``;
- ``β = sigmoid(b)``, ``g = −exp(A_log) · softplus(a + dt_bias)`` per
  value head;
- per value head, with the state S ``[Dk, Dv]``: ``S ← exp(g)·S``; ``u =
  β·(v − Sᵀk)``; ``S ← S + k·uᵀ``; ``o = Sᵀq``;
- the gated norm per value head: ``r(o · rsqrt(mean(o²) + eps) · w ·
  silu(z))``, all in fp32, rounded once.

A padded prompt position (mask 0) has conv input 0, β = 0 and g = 0: it
leaves both states as they were, so a left-padded prompt gives the
outputs of the same prompt unpadded.

KDA departs from GDN in four places, for one row and layer:

- inputs: three projections q, k, v ``[..., H·D]`` (one value head a key
  head), each with its own conv channels (the conv input is ``[q ‖ k ‖ v]``
  as for GDN, the conv state likewise); the decay's low-rank projection f
  ``[..., H·Dk]``, b ``[..., H]`` and the output gate's low-rank projection
  og ``[..., H·Dv]``;
- the decay is a vector a head: ``g = −exp(A_log[h]) · softplus(f +
  dt_bias)`` with ``dt_bias`` ``[H·Dk]``, and ``S ← Diag(exp(g))·S`` scales
  each key row of the state by its own factor;
- the gated norm gates by ``sigmoid(og)`` in place of ``silu(z)``;
- a prefill runs the step once a position (:func:`kda_prefill`); a padded
  position has q, k, v 0 and f, b −∞, so g = 0 and β = 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ospo_tpu_torch.utils.profiling import count_launch

L2_EPS = 1e-6
# what the kernel takes
KERNEL_DK = KERNEL_DV = 128
KERNEL_CONV = 4
KERNEL_RATIO = 2
# KDA heads a block of the kernel takes: their number must divide by it
KDA_PAIR = 2


def split_heads(qkvz: torch.Tensor, ba: torch.Tensor, hk: int, dk: int, dv: int,
                ratio: int):
    """``[..., Hk·(2Dk + 2r·Dv)]`` and ``[..., Hk·2r]`` → (the conv input
    ``[..., C]`` in ``[q ‖ k ‖ v]`` order, z ``[..., Hv, Dv]``, b and a
    ``[..., Hv]``)."""
    lead = qkvz.shape[:-1]
    per = qkvz.view(*lead, hk, 2 * dk + 2 * ratio * dv)
    q, k = per[..., :dk], per[..., dk:2 * dk]
    v = per[..., 2 * dk:2 * dk + ratio * dv]
    z = per[..., 2 * dk + ratio * dv:].reshape(*lead, hk * ratio, dv)
    bav = ba.view(*lead, hk, 2 * ratio)
    b = bav[..., :ratio].reshape(*lead, hk * ratio)
    a = bav[..., ratio:].reshape(*lead, hk * ratio)
    x = torch.cat([q.reshape(*lead, -1), k.reshape(*lead, -1), v.reshape(*lead, -1)], -1)
    return x, z, b, a


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


def qkv_heads(act: torch.Tensor, hk: int, dk: int, ratio: int):
    """The conv's output ``[..., C]`` (fp32, after SiLU) → q, k ``[..., Hv,
    Dk]`` (normalised, q scaled, repeated for the value heads), v ``[...,
    Hv, Dv]``."""
    lead = act.shape[:-1]
    q = _l2(act[..., :hk * dk].reshape(*lead, hk, dk)) * dk ** -0.5
    k = _l2(act[..., hk * dk:2 * hk * dk].reshape(*lead, hk, dk))
    v = act[..., 2 * hk * dk:].reshape(*lead, hk * ratio, -1)
    return (q.repeat_interleave(ratio, dim=-2), k.repeat_interleave(ratio, dim=-2), v)


def gates(b: torch.Tensor, a: torch.Tensor, a_log: torch.Tensor,
          dt_bias: torch.Tensor):
    """→ (β, g) in fp32."""
    beta = torch.sigmoid(b.float())
    g = -torch.exp(a_log.float()) * F.softplus(a.float() + dt_bias.float())
    return beta, g


def gated_norm(o: torch.Tensor, z: torch.Tensor, w: torch.Tensor, eps: float,
               dtype) -> torch.Tensor:
    """``r(o · rsqrt(mean(o²) + eps) · w · silu(z))`` over the last axis,
    in fp32."""
    o = o.float()
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + eps)
    return (o * w.float() * F.silu(z.float())).to(dtype)


def delta_rule_chunked(q, k, v, g, beta, state=None, chunk: int = 64):
    """The delta rule over T positions from ``state`` (zeros if None), in
    chunks of ``chunk``: q, k ``[B, T, H, Dk]``, v ``[B, T, H, Dv]``, g,
    β ``[B, T, H]`` (fp32) → (o ``[B, T, H, Dv]`` fp32, the final state
    ``[B, H, Dk, Dv]``).  Within a chunk, with ``G`` the cumulative sum of
    g and ``Γ_tj = exp(G_t − G_j)`` (j ≤ t): ``(I + A)·U = β·(V − e^G K·S0)``
    with ``A_tj = β_t Γ_tj k_t·k_j`` (j < t) gives the chunk's u; ``o_t =
    e^{G_t} S0ᵀq_t + Σ_{j≤t} Γ_tj (q_t·k_j) u_j``; the state carried on
    is ``e^{G_C}·S0 + Σ_j exp(G_C − G_j) k_j u_jᵀ``."""
    B, T, H, dk = k.shape
    dv = v.shape[-1]
    pad = (-T) % chunk
    q, k, v = (F.pad(t.float().transpose(1, 2), (0, 0, 0, pad)) for t in (q, k, v))
    g, beta = (F.pad(t.float().transpose(1, 2), (0, pad)) for t in (g, beta))
    S = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device) \
        if state is None else state.float()
    n = q.shape[2] // chunk
    dev = q.device
    incl = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    strict = incl.tril(-1)
    eye = torch.eye(chunk, dtype=torch.float32, device=dev)
    outs = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc, gc, bc = q[:, :, sl], k[:, :, sl], v[:, :, sl], g[:, :, sl], beta[:, :, sl]
        G = gc.cumsum(-1)                                          # [B, H, C]
        diff = G[..., :, None] - G[..., None, :]
        decay = torch.where(incl, diff, torch.full_like(diff, -float("inf"))).exp()
        A = torch.where(strict, bc[..., :, None] * (kc @ kc.transpose(-1, -2)) * decay,
                        torch.zeros_like(decay))
        eg = G.exp()[..., None]
        rhs = bc[..., None] * (vc - (eg * kc) @ S)
        U = torch.linalg.solve_triangular(eye + A, rhs, upper=False, unitriangular=True)
        outs.append((eg * qc) @ S + ((qc @ kc.transpose(-1, -2)) * decay) @ U)
        tail = (G[..., -1:] - G).exp()[..., None]                  # [B, H, C, 1]
        S = G[..., -1, None, None].exp() * S + (kc * tail).transpose(-1, -2) @ U
    o = torch.cat(outs, dim=2)[:, :, :T].transpose(1, 2)
    return o, S


def conv_prefill(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of ``x`` ``[B, T, C]`` (zeros before the first
    position) by ``w`` ``[C, K]`` in fp32, then SiLU → ``[B, T, C]``."""
    K = w.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    T = x.shape[1]
    out = sum(xp[:, j:j + T] * w[:, j].float() for j in range(K))
    return F.silu(out)


def decode_plain(qkvz, ba, conv_w, conv_state, state, a_log, dt_bias, norm_w,
                 hk: int, dk: int, dv: int, ratio: int, eps: float) -> torch.Tensor:
    """One T = 1 step for rows ``qkvz`` ``[B, ·]`` and ``ba``: updates
    ``conv_state`` ``[B, K - 1, C]`` and ``state`` ``[B, Hv, Dk, Dv]`` in
    place → the gated norm's output ``[B, Hv·Dv]`` in qkvz's dtype."""
    x, z, b, a = split_heads(qkvz, ba, hk, dk, dv, ratio)
    window = torch.cat([conv_state, x[:, None].to(conv_state.dtype)], dim=1)  # [B, K, C]
    conv = (window.float() * conv_w.float().T[None]).sum(1)
    conv_state.copy_(window[:, 1:])
    q, k, v = qkv_heads(F.silu(conv), hk, dk, ratio)
    beta, g = gates(b, a, a_log, dt_bias)
    S = state * g.exp()[..., None, None]
    u = beta[..., None] * (v - torch.einsum("bhkv,bhk->bhv", S, k))
    S = S + k[..., :, None] * u[..., None, :]
    state.copy_(S)
    o = torch.einsum("bhkv,bhk->bhv", S, q)
    return gated_norm(o, z, norm_w, eps, qkvz.dtype).reshape(qkvz.shape[0], -1)


def kernel_takes(qkvz: torch.Tensor, conv_state: torch.Tensor, state: torch.Tensor,
                 dk: int, dv: int, ratio: int) -> bool:
    """Whether the step runs the kernel: CUDA bf16 projections, head widths
    128, two value heads a key head, a conv of width 4, contiguous bf16
    conv state and fp32 state."""
    return (qkvz.device.type == "cuda" and qkvz.dtype == torch.bfloat16
            and dk == KERNEL_DK and dv == KERNEL_DV and ratio == KERNEL_RATIO
            and conv_state.shape[1] == KERNEL_CONV - 1
            and conv_state.dtype == torch.bfloat16 and conv_state.is_contiguous()
            and state.dtype == torch.float32 and state.is_contiguous())


def decode(qkvz, ba, conv_w, conv_state, state, a_log, dt_bias, norm_w,
           hk: int, dk: int, dv: int, ratio: int, eps: float) -> torch.Tensor:
    """:func:`decode_plain`'s step: the ``gdn_decode`` kernel where
    :func:`kernel_takes`, else the plain version."""
    if not kernel_takes(qkvz, conv_state, state, dk, dv, ratio):
        return decode_plain(qkvz, ba, conv_w, conv_state, state, a_log, dt_bias,
                            norm_w, hk, dk, dv, ratio, eps)
    from ospo_tpu_torch.ops import build

    rows = qkvz.shape[0]
    for name, t in (("qkvz", qkvz), ("ba", ba)):
        if t.stride(-1) != 1:
            raise ValueError(f"gdn_decode: {name} must have unit column stride")
    for t, dt in ((conv_w, torch.bfloat16), (a_log, torch.float32),
                  (dt_bias, torch.float32), (norm_w, torch.float32)):
        if not t.is_contiguous() or t.dtype != dt:
            raise ValueError("gdn_decode: the layer's weights must be contiguous, the "
                             "conv's bf16, A_log, dt_bias and the norm's fp32")
    out = torch.empty((rows, hk * ratio * dv), dtype=qkvz.dtype, device=qkvz.device)
    build.check(build.load("gated_delta").ospo_gdn_decode(
        qkvz.data_ptr(), ba.data_ptr(), conv_w.data_ptr(), conv_state.data_ptr(),
        state.data_ptr(), a_log.data_ptr(), dt_bias.data_ptr(), norm_w.data_ptr(),
        out.data_ptr(), rows, hk, qkvz.stride(0), ba.stride(0), L2_EPS, float(eps),
        torch.cuda.current_stream(qkvz.device).cuda_stream), "gdn_decode")
    count_launch("gdn_decode")
    return out


# ---------------------------------------------------------------------------
# Kimi Delta Attention (KDA): a decay a key row
# ---------------------------------------------------------------------------


def kda_decode_plain(q, k, v, f, b, og, conv_w, conv_state, state, a_log, dt_bias,
                     norm_w, heads: int, eps: float) -> torch.Tensor:
    """One T = 1 KDA step for rows ``q``, ``k``, ``v``, ``f``, ``og`` ``[B,
    H·D]`` and ``b`` ``[B, H]``: updates ``conv_state`` ``[B, K - 1, 3·H·D]``
    and ``state`` ``[B, H, Dk, Dv]`` in place → the gated norm's output
    ``[B, H·Dv]`` in q's dtype."""
    B = q.shape[0]
    x = torch.cat([q, k, v], dim=-1)
    window = torch.cat([conv_state, x[:, None].to(conv_state.dtype)], dim=1)  # [B, K, C]
    conv = (window.float() * conv_w.float().T[None]).sum(1)
    conv_state.copy_(window[:, 1:])
    act = F.silu(conv).view(B, 3, heads, -1)
    dk = act.shape[-1]
    qh, kh, vh = _l2(act[:, 0]) * dk ** -0.5, _l2(act[:, 1]), act[:, 2]
    beta = torch.sigmoid(b.float())
    g = -torch.exp(a_log.float())[:, None] * F.softplus(
        f.float().view(B, heads, -1) + dt_bias.float().view(heads, -1))
    S = state * g.exp()[..., None]
    u = beta[..., None] * (vh - torch.einsum("bhkv,bhk->bhv", S, kh))
    S = S + kh[..., :, None] * u[..., None, :]
    state.copy_(S)
    o = torch.einsum("bhkv,bhk->bhv", S, qh)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + eps)
    gate = torch.sigmoid(og.float().view(B, heads, -1))
    return (o * norm_w.float() * gate).to(q.dtype).reshape(B, -1)


def kda_decode(q, k, v, f, b, og, conv_w, conv_state, state, a_log, dt_bias, norm_w,
               heads: int, eps: float) -> torch.Tensor:
    """:func:`kda_decode_plain`'s step: the plain version on the CPU, the
    ``kda_decode`` kernel on the card.  The kernel takes bf16 inputs with a
    unit column stride (q, k, v, f and og with one row stride), heads of
    128 in pairs, a conv of width 4, a contiguous bf16 conv state, a
    contiguous fp32 state and the weights' dtypes below; any other CUDA
    input raises ``ValueError``."""
    if q.device.type == "cpu":
        return kda_decode_plain(q, k, v, f, b, og, conv_w, conv_state, state, a_log,
                                dt_bias, norm_w, heads, eps)
    from ospo_tpu_torch.ops import build

    rows, width = q.shape
    xs = (q, k, v, f, og)
    if not (all(t.dtype == torch.bfloat16 and t.shape == (rows, width) and t.stride(-1) == 1
                and t.stride(0) == q.stride(0) for t in xs)
            and b.dtype == torch.bfloat16 and b.shape == (rows, heads) and b.stride(-1) == 1
            and width == heads * KERNEL_DK and heads % KDA_PAIR == 0
            and conv_state.shape == (rows, KERNEL_CONV - 1, 3 * width)
            and conv_state.dtype == torch.bfloat16 and conv_state.is_contiguous()
            and state.shape == (rows, heads, KERNEL_DK, KERNEL_DV)
            and state.dtype == torch.float32 and state.is_contiguous()):
        raise ValueError(
            f"kda_decode: q {q.dtype} {tuple(q.shape)} (strides {q.stride()}), b {b.dtype} "
            f"{tuple(b.shape)}, conv state {conv_state.dtype} {tuple(conv_state.shape)}, "
            f"state {state.dtype} {tuple(state.shape)}, {heads} heads; it takes bf16 rows "
            f"with a unit column stride and one row stride, heads of {KERNEL_DK} in pairs, "
            f"a conv of width {KERNEL_CONV}, a contiguous bf16 conv state and fp32 state")
    for t, dt in ((conv_w, torch.bfloat16), (a_log, torch.float32),
                  (dt_bias, torch.float32), (norm_w, torch.float32)):
        if not t.is_contiguous() or t.dtype != dt:
            raise ValueError("kda_decode: the layer's weights must be contiguous, the "
                             "conv's bf16, A_log, dt_bias and the norm's fp32")
    out = torch.empty((rows, width), dtype=q.dtype, device=q.device)
    build.check(build.load("gated_delta").ospo_kda_decode(
        *(t.data_ptr() for t in (q, k, v, f, b, og, conv_w, conv_state, state, a_log,
                                 dt_bias, norm_w, out)),
        rows, heads, q.stride(0), b.stride(0), L2_EPS, float(eps),
        torch.cuda.current_stream(q.device).cuda_stream), "kda_decode")
    count_launch("kda_decode")
    return out


def kda_prefill(q, k, v, f, b, og, valid, conv_w, conv_state, state, a_log, dt_bias,
                norm_w, heads: int, eps: float) -> torch.Tensor:
    """T positions ``[B, T, ·]`` from the given states (updated in place) as
    T steps of :func:`kda_decode` → ``[B, T, H·Dv]``.  ``valid`` ``[B, T]``
    bool (or None): a padded position has q, k, v 0 and f, b −∞, so it
    leaves both states as they were (conv input 0, ``g = 0``, ``β = 0``)."""
    if valid is not None:
        keep = valid[..., None]
        q, k, v = (t * keep.to(t.dtype) for t in (q, k, v))
        f, b = (torch.where(keep, t, torch.full_like(t, -float("inf"))) for t in (f, b))
    return torch.stack([
        kda_decode(q[:, t], k[:, t], v[:, t], f[:, t], b[:, t], og[:, t], conv_w,
                   conv_state, state, a_log, dt_bias, norm_w, heads, eps)
        for t in range(q.shape[1])], dim=1)
