"""Weight quantization — counterpart of ``ospo_tpu/ops/quant.py``.

A quantized matrix is a dict in torch layout ``[out, in]``:

- int8 (W8A16): ``{"q": int8 [..., F, D], "s": f32 [..., F]}``,
  per-output-row symmetric scales;
- w8a8: ``{"q": int8 [..., F, D], "sa": f32 [..., F]}``, the same payload,
  whose product quantizes the activations per token too and multiplies
  int8 × int8 into exact int32 (:78-148);
- int4 and int4n (W4A16): ``{"q4": int8 [..., F/2, D], "s": f32 [..., F]}``,
  two output rows packed per byte;
- int4g: ``{"q4": int8 [..., F/2, D], "gs": f32 [..., F, D/group]}``, the
  same packing with one scale per group of input columns.

The T == 1 int4 products run in ``ops/int4_matmul.py`` (the CUDA kernels);
the forms here serve the prefill (T > 1).  The T == 1 int8 product on the
card runs ``csrc/w8a16_matmul.cu`` (:func:`w8a16_matmul`); ``_w8a16`` is its
plain version and serves the rest.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from ospo_tpu_torch.utils.profiling import count_launch

QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def parse_kv_quant(value):
    """Normalize a config ``kv_quant`` spelling to False | "int8" | "int4".

    None/False/""/"false"/"none"/"0"/"off"/"bf16" → False (bf16 cache);
    True/"true"/"1"/"on" → "int8"; "int8"/"int4" pass through.  Anything
    else raises: a silent bf16 fallback on a typo would change the planned
    KV memory without an error."""
    if value is None or value is False:
        return False
    if value is True:
        return "int8"
    s = str(value).strip().lower()
    if s in ("", "false", "none", "0", "off", "bf16"):
        return False
    if s in ("true", "1", "on"):
        return "int8"
    if s in ("int8", "int4"):
        return s
    raise ValueError(
        f"unrecognized kv_quant value {value!r}: use int8, int4, "
        "true (= int8), or false/unset (bf16 cache)")


def quantize_matrix(w: torch.Tensor, amax_reduce=None) -> Dict[str, torch.Tensor]:
    """[..., F, D] → {q: int8, s: f32 [..., F]} per-output-row symmetric.

    As in the reference, the division runs in the weight's dtype (the scale
    is cast to it first) and rounds half to even.  ``amax_reduce`` joins
    the abs-max of a row whose columns are spread over ranks (a
    row-parallel shard), so its scale is the whole row's."""
    amax = w.float().abs().amax(dim=-1)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    s = amax / 127.0
    s = s.clamp_min(1e-12)
    q = torch.round(w / s[..., None].to(w.dtype)).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def _w8a16(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (x @ q.to(x.dtype).T) * s.to(x.dtype)


class _W8A16(torch.autograd.Function):
    """:func:`_w8a16` under autograd for a frozen int8 trunk
    (``quantize_base``): it saves ``q`` and ``s`` only and converts the
    payload again for dX, where autograd through the plain form would keep
    every matrix's x-dtype copy alive until the backward.  The weight gets
    no gradient: the quantized base is a constant, as in the JAX package."""

    @staticmethod
    def forward(ctx, x, q, s):
        ctx.save_for_backward(q, s)
        return _w8a16(x, q, s)

    @staticmethod
    def backward(ctx, dy):
        q, s = ctx.saved_tensors
        return (dy * s.to(dy.dtype)) @ q.to(dy.dtype), None, None


def quantized_matmul(x: torch.Tensor, qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """y = x @ Wᵀ with W stored int8: the payload converted to x's dtype,
    then the per-row scale in x's dtype (``llama.py:207-209``).  Where x
    needs a gradient it runs as :class:`_W8A16`; a T == 1 product on the
    card runs the kernel (:func:`w8a16_kernel_takes`)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _W8A16.apply(x, qw["q"], qw["s"])
    if w8a16_kernel_takes(x, [qw]):
        return w8a16_matmul(x, [qw])[0]
    return _w8a16(x, qw["q"], qw["s"])


def quantized_matmuls(x: torch.Tensor, qws) -> list:
    """:func:`quantized_matmul` of each int8 ``{"q", "s"}`` matrix on one x;
    on the kernel's route they share launches (up to
    ``W8A16_MAX_MATS`` a launch)."""
    if not w8a16_kernel_takes(x, qws):
        return [quantized_matmul(x, qw) for qw in qws]
    out = []
    for i in range(0, len(qws), W8A16_MAX_MATS):
        out += w8a16_matmul(x, qws[i:i + W8A16_MAX_MATS])
    return out


# ---------------------------------------------------------------------------
# The T == 1 kernel, ``csrc/w8a16_matmul.cu``
# ---------------------------------------------------------------------------
# The same function as :func:`_w8a16`, r(r(Σ x · q) · r(s)) with the sum in
# fp32, read from the int8 payload without a bf16 copy.  The route follows
# from the input alone (:func:`w8a16_kernel_takes`).

W8A16_MAX_MATS = 3    # matrices one launch takes
W8A16_ROWS = 128      # weight rows a block
W8A16_CHUNK = 128     # columns of K a stage; a split is whole chunks


def w8a16_kernel_takes(x: torch.Tensor, qws) -> bool:
    """Whether the product of ``x`` by the int8 matrices ``qws`` runs the
    kernel: bf16 x ``[B, 1, D]`` on the card, D a multiple of 16, no
    gradient wanted, every payload a contiguous ``[F, D]`` int8 matrix
    beside it; x and the payloads 16-byte aligned (the kernel's copies)."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 3 \
            or x.shape[1] != 1 or x.shape[2] % 16 \
            or (x.requires_grad and torch.is_grad_enabled()) \
            or (x.is_contiguous() and x.data_ptr() % 16):
        return False
    return all(qw["q"].dim() == 2 and qw["q"].shape[1] == x.shape[2]
               and qw["q"].dtype == torch.int8 and qw["q"].device == x.device
               and qw["q"].is_contiguous() and qw["q"].data_ptr() % 16 == 0
               for qw in qws)


def w8a16_split(m: int, fs, d: int) -> int:
    """Blocks of a cluster that split K for M rows of x and matrices of F
    rows: 2 where the launch has 40 or more blocks of rows, else 6, at most
    D's 128-column chunks (the splits that measured fastest on the H100 at
    the 7B, 1B and MLA projections, ``scripts/w8a16_kernel_times.py
    --splits``)."""
    tiles = sum(-(-f // W8A16_ROWS) for f in fs) * -(-m // (8 * _n_tiles(m)))
    return max(1, min(-(-d // W8A16_CHUNK), 2 if tiles >= 40 else 6))


def w8a16_matmul(x: torch.Tensor, qws, n_split: Optional[int] = None) -> list:
    """y = x @ Wᵀ for each of 1 to ``W8A16_MAX_MATS`` int8 matrices
    ``{"q": [F, D], "s": [F]}`` in one launch of the kernel → ``[B, 1, F]``
    each.  K is split across ``n_split`` blocks of a cluster (1 to 8; by
    default :func:`w8a16_split`)."""
    from ospo_tpu_torch.ops import build

    if not 1 <= len(qws) <= W8A16_MAX_MATS or not w8a16_kernel_takes(x, qws):
        raise ValueError("w8a16_matmul: takes bf16 x [M, 1, D] on the card "
                         "(D a multiple of 16) and 1 to 3 contiguous int8 [F, D] "
                         "matrices, 16-byte aligned")
    x = x.contiguous()
    m, d = x.shape[0], x.shape[2]
    qs = [qw["q"] for qw in qws]
    ss = [qw["s"].float().contiguous() for qw in qws]
    fs = [q.shape[0] for q in qs]
    ys = [torch.empty((m, 1, f), dtype=x.dtype, device=x.device) for f in fs]
    if n_split is None:
        n_split = w8a16_split(m, fs, d)
    pad = [None] * (W8A16_MAX_MATS - len(qws))
    ptrs = lambda ts: [t.data_ptr() for t in ts] + pad  # noqa: E731
    build.check(build.load("w8a16_matmul").ospo_w8a16_matmul(
        x.data_ptr(), *ptrs(qs), *ptrs(ss), *ptrs(ys),
        *(fs + [0] * len(pad)), len(qws), m, d, n_split,
        torch.cuda.current_stream(x.device).cuda_stream), "w8a16_matmul")
    count_launch("w8a16_matmul")
    return ys


def _n_tiles(m: int) -> int:
    """n8 tiles of x a block of the kernel holds for M rows: 1, 2, 4, 6 or 8."""
    t = -(-min(m, 64) // 8)
    return next(n for n in (1, 2, 4, 6, 8) if t <= n)


# ---------------------------------------------------------------------------
# w8a8, ``ospo_tpu/ops/quant.py:78-203``
# ---------------------------------------------------------------------------


def quantize_matrix_w8a8(w: torch.Tensor, amax_reduce=None
                         ) -> Dict[str, torch.Tensor]:
    """[..., F, D] → {"q": int8, "sa": f32 [..., F]}: the payload of
    :func:`quantize_matrix`; the key ``"sa"`` routes the product to
    :func:`quantized_matmul_w8a8`."""
    out = quantize_matrix(w, amax_reduce)
    return {"q": out["q"], "sa": out["s"]}


def dequantize_matrix_w8a8(qw: Dict[str, torch.Tensor],
                           dtype=torch.bfloat16) -> torch.Tensor:
    return (qw["q"].float() * qw["sa"][..., None]).to(dtype)


def quantize_activations_int8(x: torch.Tensor, amax_reduce=None):
    """[..., D] → (int8 values, f32 per-row scales [..., 1]): symmetric
    per-token abs-max in fp32, the scale floored at 1e-12 after the
    division (:105-113).  ``amax_reduce`` joins the abs-max of a row whose
    columns are spread over ranks (tensor parallel)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    # divided by a tensor: by a Python number, the card multiplies by its
    # reciprocal, a unit in the last place off the quotient the CPU (and
    # the JAX package) rounds — enough to move an activation a step
    sx = (amax / amax.new_full((), 127.0)).clamp_min(1e-12)
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8), sx


def int8_matmul(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int32 product ``a @ qᵀ`` of int8 ``a`` [M, K] and ``q`` [N, K]
    (``torch._int_mm``).  On the card that call takes M > 16 and K, N
    multiples of 8: fewer rows are padded with zeros (a T == 1 decode with
    few rows) and the result cut back; other K or N raise, as there is no
    float product to fall back to."""
    m, k = a.shape
    if a.is_cuda:
        if k % 8 or q.shape[0] % 8:
            raise ValueError(f"w8a8 on the card needs K and N multiples of "
                             f"8, got K={k}, N={q.shape[0]}")
        if m <= 16:
            a = torch.cat([a, a.new_zeros((24 - m, k))])
    return torch._int_mm(a, q.T)[:m]


def _w8a8_raw(x: torch.Tensor, q: torch.Tensor, sa: torch.Tensor,
              amax_reduce=None) -> torch.Tensor:
    """Dynamic per-token int8 activations, the int8 × int8 product in int32,
    then ``· sx · sa`` in fp32, cast to x's dtype (:116-121)."""
    xq, sx = quantize_activations_int8(x, amax_reduce)
    y = int8_matmul(xq.reshape(-1, xq.shape[-1]), q)
    y = y.view(*x.shape[:-1], q.shape[0]).float()
    return (y * sx * sa).to(x.dtype)


class _W8A8(torch.autograd.Function):
    """:func:`_w8a8_raw` with the straight-through backward of the JAX
    package's ``custom_vjp`` (:128-148): differentiated as the dequantized
    product, ``dx = ((g · sa) in bf16) @ q in bf16``; the frozen ``q`` and
    ``sa`` get no gradient."""

    @staticmethod
    def forward(ctx, x, q, sa, amax_reduce=None):
        ctx.save_for_backward(q, sa)
        return _w8a8_raw(x, q, sa, amax_reduce)

    @staticmethod
    def backward(ctx, g):
        q, sa = ctx.saved_tensors
        gf = (g.float() * sa).to(torch.bfloat16)
        return (gf @ q.to(torch.bfloat16)).to(g.dtype), None, None, None


def quantized_matmul_w8a8(x: torch.Tensor, qw: Dict[str, torch.Tensor],
                          amax_reduce=None) -> torch.Tensor:
    """y = x @ Wᵀ with both sides int8; where x needs a gradient it runs as
    :class:`_W8A8` (a w8a8 frozen trunk under LoRA training).
    ``amax_reduce``: see :func:`quantize_activations_int8`."""
    if x.requires_grad and torch.is_grad_enabled():
        return _W8A8.apply(x, qw["q"], qw["sa"], amax_reduce)
    return _w8a8_raw(x, qw["q"], qw["sa"], amax_reduce)


# Inside w8a16_override() a w8a8 weight runs weight-only (the same int8
# payload, no activation quantization): the scoring engine's question
# suffixes under ``readout_w8a16`` (:151-203).  A flag of the calling
# thread, read at call time (the JAX package's is read at trace time).
_OVERRIDE = threading.local()


@contextlib.contextmanager
def w8a16_override():
    prev = w8a16_active()
    _OVERRIDE.w8a16 = True
    try:
        yield
    finally:
        _OVERRIDE.w8a16 = prev


def w8a16_active() -> bool:
    return getattr(_OVERRIDE, "w8a16", False)


def weight_only_int8(w) -> Optional[Dict[str, torch.Tensor]]:
    """The ``{"q", "s"}`` matrix a weight-only int8 product reads of ``w``:
    an int8 matrix itself, or a w8a8 payload with its row scales under
    :func:`w8a16_override` ((x @ qᵀ) · sa); None for any other weight."""
    if not isinstance(w, dict) or "q" not in w:
        return None
    if "s" in w:
        return w
    if "sa" in w and w8a16_active():
        return {"q": w["q"], "s": w["sa"]}
    return None


# ---------------------------------------------------------------------------
# weight-only int4 (W4A16), ``ospo_tpu/ops/quant.py:205-329``
# ---------------------------------------------------------------------------
# Two output rows share a byte: row r in the low nibble, row r + F/2 in the
# high nibble, each a sign-extended 15-level value in [-7, 7].

INT4_GROUP = 128  # scale group along the input dim (clamped to D)


def _pack_halves(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] [..., F, D] → packed bytes [..., F/2, D].  The
    nibbles are combined in int32 and the byte reinterpreted, which gives
    the bits of the reference's wrapping int8 ``(low & 0xF) | (high << 4)``."""
    f = q.shape[-2]
    low = q[..., : f // 2, :].to(torch.int32) & 0x0F
    high = q[..., f // 2:, :].to(torch.int32) & 0x0F
    return (low | (high << 4)).to(torch.uint8).view(torch.int8)


def quantize_matrix_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., F, D] → {"q4": int8 [..., F/2, D], "s": f32 [..., F]}: per
    output row symmetric, the division in the weight's dtype as in
    :func:`quantize_matrix`."""
    f = w.shape[-2]
    if f % 2:
        raise ValueError(f"int4 weight packing needs an even out dim, got {f}")
    s = (w.float().abs().amax(dim=-1) / 7.0).clamp_min(1e-12)
    q = torch.round(w / s[..., None].to(w.dtype)).clamp(-7, 7).to(torch.int8)
    return {"q4": _pack_halves(q), "s": s}


def quantize_matrix_int4_group(w: torch.Tensor,
                               group: int = INT4_GROUP) -> Dict[str, torch.Tensor]:
    """[..., F, D] → {"q4": int8 [..., F/2, D], "gs": f32 [..., F, D/group]}:
    one scale per ``group`` contiguous input columns of each output row;
    ``group`` clamps to D and must then divide it."""
    *lead, f, d = w.shape
    group = min(group, d)
    if f % 2 or d % group:
        raise ValueError(f"int4 group packing needs an even out dim and a "
                         f"group dividing the in dim: F={f}, D={d}, group={group}")
    wg = w.reshape(*lead, f, d // group, group)
    s = (wg.float().abs().amax(dim=-1) / 7.0).clamp_min(1e-12)
    q = torch.round(wg / s[..., None].to(w.dtype)).clamp(-7, 7).to(torch.int8)
    return {"q4": _pack_halves(q.reshape(*lead, f, d)), "gs": s}


def unpack_int4_halves(q4: torch.Tensor):
    """Packed bytes → (low, high) signed int8 nibble planes.  The low nibble
    is sign-extended as ``((b & 0xF) ^ 8) - 8`` (no shift that could wrap),
    the high one by the arithmetic right shift."""
    low = ((q4 & 0x0F) ^ 0x08) - 0x08
    return low, q4 >> 4


def dequantize_matrix_int4(qw: Dict[str, torch.Tensor],
                           dtype=torch.bfloat16) -> torch.Tensor:
    low, high = unpack_int4_halves(qw["q4"])
    w = torch.cat([low, high], dim=-2).float()
    return (w * qw["s"][..., None]).to(dtype)


def dequantize_matrix_int4_group(qw: Dict[str, torch.Tensor],
                                 dtype=torch.bfloat16) -> torch.Tensor:
    low, high = unpack_int4_halves(qw["q4"])
    q = torch.cat([low, high], dim=-2).float()
    *lead, f, d = q.shape
    g = qw["gs"].shape[-1]
    q = q.reshape(*lead, f, g, d // g) * qw["gs"][..., None]
    return q.reshape(*lead, f, d).to(dtype)


def quantized_matmul_int4(x: torch.Tensor, qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """y = x @ Wᵀ with per-row int4 W: one product per nibble plane against
    its output half, each scaled in x's dtype (the reference's two-plane
    form)."""
    low, high = unpack_int4_halves(qw["q4"])
    f2 = qw["q4"].shape[-2]
    s = qw["s"].to(x.dtype)
    return torch.cat([(x @ low.to(x.dtype).T) * s[..., :f2],
                      (x @ high.to(x.dtype).T) * s[..., f2:]], dim=-1)


def quantized_matmul_int4_group(x: torch.Tensor,
                                qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """y = x @ Wᵀ with group-scaled int4 W, for the prefill (T > 1): one
    layer's matrix dequantized to x's dtype, then one product.  The
    reference's form scales fp32 per-group partial sums through a
    [B, T, F, G] intermediate, too large at the serving prefill; the two
    agree to fp32 rounding in fp32."""
    return x @ dequantize_matrix_int4_group(qw, x.dtype).T


_QUANT_FNS = {
    "int8": quantize_matrix,
    "w8a8": quantize_matrix_w8a8,
    "int4": quantize_matrix_int4,
    "int4g": quantize_matrix_int4_group,
    # the JAX package stores int4n as jnp.int4 {"q", "s"} (:332-350): the
    # same values as int4 (scale in fp32, round(w / s in w's dtype), ±7).
    # torch has no int4 tensor a product reads, so the port packs them as
    # int4 does and serves them on the same paths
    "int4n": quantize_matrix_int4,
}


def quant_mode(value) -> str:
    """A ``quantize`` argument → "" (model dtype) | "int8" | "w8a8" |
    "int4" | "int4g" | "int4n"; True means int8; anything else is an
    error."""
    if value is None or value is False:
        return ""
    if value is True:
        return "int8"
    mode = str(value).strip().lower()
    if mode in ("", "none", "false", "bf16"):
        return ""
    if mode not in _QUANT_FNS:
        raise ValueError(f"unrecognized quantize value {value!r}: use int8, "
                         "w8a8, int4, int4g, int4n, or unset/none/bf16")
    return mode


def quant_fn(mode):
    """The per-matrix quantize function of ``mode`` (:func:`quant_mode`)."""
    return _QUANT_FNS[quant_mode(mode)]


@torch.no_grad()
def quantize_layers(layers: Dict, mode, amax_reduce=None) -> Dict:
    """Quantize the stacked ``QUANTIZABLE`` matrices of a trunk's ``layers``
    in place, one layer's matrix at a time: each model-dtype stack is
    dropped as its quantized replacement lands, so at most one stack and
    one layer's temporaries exist beside the quantized trunk (the JAX
    package's ``quantize_llama_params_incremental``, ``quant.py:410-437``).

    ``amax_reduce`` (int8 and w8a8): the layers are a tensor-parallel
    shard, and ``{name: fn}`` joins the row abs-max of each named matrix
    whose columns the shard cuts, so every scale is the whole trunk's."""
    qfn = quant_fn(mode)
    amax_reduce = amax_reduce or {}
    if amax_reduce and quant_mode(mode) not in ("int8", "w8a8"):
        raise ValueError(f"quantizing a tensor-parallel shard takes int8 or "
                         f"w8a8, got {mode!r}: quantize the whole trunk")
    for name in QUANTIZABLE:
        w = layers[name]
        reduce = ({"amax_reduce": amax_reduce[name]}
                  if name in amax_reduce else {})
        stacked = None
        for li in range(w.shape[0]):
            qw = qfn(w[li], **reduce)
            if stacked is None:
                stacked = {k: torch.empty((w.shape[0], *t.shape), dtype=t.dtype,
                                          device=t.device)
                           for k, t in qw.items()}
            for k, t in qw.items():
                stacked[k][li] = t
        layers[name] = stacked
        del w
    return layers
