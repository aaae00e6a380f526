"""Routed experts of a mixture-of-experts (MoE) FFN: routing, grouping and
grouped W8A16 kernels in CUDA C++ (``csrc/moe_experts.cu``), a combine in
Triton, and their plain PyTorch version.

No TPU kernel of the JAX package has this function: the JAX package runs
no MoE trunk.  The kernels were added for DeepSeek-V2-style layers
(``models/deepseek_v2.py``), whose routed experts are most of the bytes a
decode step reads: 64 experts of ``[2F, D]`` and ``[D, F]`` int8 rows a
layer, of which nearly all get a row in a 48-row step.  The step is bound
by those bytes, so the weights are read once, as int8, and converted to
bf16 in registers (``ops/quant.py``'s W8A16 product makes a bf16 copy of
each weight first, which over 64 experts would triple the bytes).

Semantics, shared by the kernels and the plain version, for tokens
``x [N, D]`` (rows of the model dtype), a router ``[E, D]`` and
``top_k``:

- router logits in fp32 (``x · Wᵀ``, bf16 products summed in fp32), a
  softmax over the E experts, the ``top_k`` largest scores in order
  (ties: the lower expert), their weights the scores themselves, or
  renormalised to sum 1 with ``norm_topk``, times ``scaling``;
- sigmoid routing (Kimi, a ``score_bias`` given): the scores are the
  logits' sigmoids, the ``top_k`` are taken over ``score + score_bias``
  (the fp32 correction bias ``[E]``), and the weights are the chosen
  experts' unbiased scores, renormalised with ``norm_topk`` over ``(Σ +
  1e-20)``, times ``scaling``;
- the N · top_k (token, slot) rows are grouped by expert: ``counts[e]``,
  ``offsets`` ``[E + 1]`` (exclusive prefix sums) and ``sorted_src``
  ``[N·k]``, the flat (token · k + slot) index of each grouped row; within
  an expert the rows may lie in any order (each output row depends on its
  own input row alone, so the order changes no value);
- a tile table: expert ``e`` owns ``ceil(counts[e] / block_m)`` tiles of
  ``block_m`` grouped rows, listed expert by expert; ``tile_expert[t]`` is
  E for every tile past the last (the grid is sized for the worst case,
  ``N·k // block_m + E`` tiles, and such a tile exits at once);
- gate and up: for each grouped row, ``g = r(x·Qgᵀ · sg)``, ``u = r(x·Quᵀ ·
  su)`` (the int8 rows ``Q`` and their fp32 per-row scales ``s`` of
  ``w13 = {"q": [E, 2F, D], "s": [E, 2F]}``, gate rows first; products
  summed in fp32, ``r`` rounds to the model dtype), then ``h = r(r(silu(g))
  · u)``;
- down: ``y = r(h·Qdᵀ · sd)`` with ``w2 = {"q": [E, D, F], "s": [E, D]}``,
  stored at the row's flat (token, slot) index;
- combine: ``out[t] = r(Σ_j w[t, j] · y[t·k + j])``, the sum in fp32.

Shared experts ride along as ``n_shared`` more experts after the E routed
ones (``w13``, ``w2`` hold ``E + n_shared``): every token takes each of them
in a slot of its own, after its ``top_k``, with weight 1, so a token has
``top_k + n_shared`` slots.  A shared MLP of width ``n_shared · F`` splits
into such experts exactly: its gate and up rows by halves, its down
columns likewise, each part keeping the whole row's scale.  With a shared
gate (Qwen3-Next) the router carries one more row ``w_sg`` after the E
routed ones, and every shared slot's weight is ``sigmoid(x · w_sg)`` (the
logit summed as the routed ones are) instead of 1.

An expert share (expert parallel): the layer holds ``held = (e0, n)``, the
routed experts ``[e0, e0 + n)`` of the E it routes over, as the first n of
``w13`` and ``w2``.  Routing is over all E; a slot's id is its expert's
place among the held ones, or -1 for an expert this layer does not hold.
Such a slot makes no grouped row and adds nothing to the combine, so the
layer's output is the part of the FFN its own experts (and the shared
ones) give.  Every expert held (``held`` None) is the plain layer.

The kernels (``moe_route``, ``moe_align``, ``moe_gate_up``, ``moe_down``,
``moe_combine``) read no host value and the host reads none of theirs, so
a decode step that runs them can be captured in a CUDA graph.  The plain
version's routing and grouping (``topk``, ``index_add_``, ``cumsum``, a
stable ``argsort``) also read nothing back, but inside the graph they are
~40 small launches a layer, 0.111 ms at a decode step's 48 tokens against
the kernels' few µs (``PERF.md``).  ``moe_align`` adds each expert's rows
to ``counts``, which the caller zeroes (a step zeroes one ``[layers, E +
n_shared]`` block for all its layers); it groups rows of one expert in
any order.  Each kernel's launches are counted under its name in
``utils/profiling``'s table.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ospo_tpu_torch.utils.profiling import count_launch

# grouped rows a tile: decode steps (a few rows an expert) take the small
# tile, prefills (hundreds of rows an expert) the large one, which reads
# each expert's weights fewer times (the kernels take these two)
BLOCK_M_DECODE = 16
BLOCK_M_PREFILL = 64
# what the kernels take: routed experts, top-k, experts with the shared
MAX_ROUTED = 512
MAX_TOP_K = 16
MAX_EXPERTS = 1024


def block_m(rows: int, experts: int) -> int:
    """The tile height for ``rows`` grouped rows over ``experts``."""
    return BLOCK_M_DECODE if rows <= BLOCK_M_DECODE * experts else BLOCK_M_PREFILL


def max_tiles(rows: int, experts: int, bm: int) -> int:
    """Tiles the grid is sized for: no expert split leaves more."""
    return rows // bm + experts


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _scores(x: torch.Tensor, router: torch.Tensor, score_bias=None):
    """→ (each expert's score [N, E], what the top-k is taken over) in fp32:
    the softmax twice, or the sigmoid and the sigmoid plus ``score_bias``."""
    logits = x.float() @ router.float().T
    if score_bias is None:
        scores = torch.softmax(logits, dim=-1)
        return scores, scores
    scores = torch.sigmoid(logits)
    return scores, scores + score_bias.float()


def _weights(chosen: torch.Tensor, norm_topk: bool, score_bias, scaling: float):
    """The chosen experts' scores [N, k] → their weights."""
    if norm_topk:
        total = chosen.sum(dim=-1, keepdim=True)
        chosen = chosen / (total if score_bias is None else total + 1e-20)
    return chosen * scaling


def route_plain(x: torch.Tensor, router: torch.Tensor, top_k: int,
                norm_topk: bool = False, scaling: float = 1.0, score_bias=None):
    """→ (expert ids [N, k] int32, weights [N, k] fp32)."""
    scores, choice = _scores(x, router, score_bias)
    idx = torch.topk(choice, top_k, dim=-1).indices
    w = _weights(scores.gather(1, idx), norm_topk, score_bias, scaling)
    return idx.to(torch.int32), w


def with_shared(topi: torch.Tensor, topw: torch.Tensor, experts: int,
                n_shared: int, gate=None):
    """The routed slots [N, k] followed by the shared experts' slots (ids
    ``experts + j``, weight 1, or ``gate`` [N] fp32 where given)."""
    if not n_shared:
        return topi, topw
    n = topi.shape[0]
    ids = torch.arange(experts, experts + n_shared, dtype=topi.dtype,
                       device=topi.device).expand(n, n_shared)
    w = torch.ones_like(topw[:, :1]) if gate is None else gate[:, None].to(topw.dtype)
    return (torch.cat([topi, ids], dim=1),
            torch.cat([topw, w.expand(n, n_shared)], dim=1))


def held_ids(topi: torch.Tensor, held) -> torch.Tensor:
    """Routed ids [N, k] → their place among the held experts ``held = (e0,
    n)``, -1 where the expert is not held."""
    if held is None:
        return topi
    e0, n = held
    local = topi - e0
    return torch.where((local >= 0) & (local < n), local, torch.full_like(local, -1))


def routing_gap(x: torch.Tensor, router: torch.Tensor, topi: torch.Tensor,
                topw: torch.Tensor, top_k: int, norm_topk: bool = False,
                scaling: float = 1.0, score_bias=None):
    """How a routing (``route``'s ids and weights; the shared slots past
    ``top_k`` are not read) departs from ``route_plain``'s on the same
    tokens → (tokens whose routed experts differ, the largest shortfall of
    a chosen expert's plain choice score below the plain k-th one, the
    largest weight error against the plain weights of the chosen experts).
    A routing whose logits are summed in another order differs only where
    scores tie to fp32 rounding, so its shortfall stays ~1e-7."""
    scores, choice = _scores(x, router, score_bias)
    ids = topi[:, :top_k].long()
    kth = choice.topk(top_k, dim=-1).values[:, -1:]
    want = route_plain(x, router, top_k, norm_topk, scaling, score_bias)[0].long()
    differ = int((ids.sort(dim=1).values != want.sort(dim=1).values).any(dim=1).sum())
    w = _weights(scores.gather(1, ids), norm_topk, score_bias, scaling)
    return (differ, float((kth - choice.gather(1, ids)).clamp_min(0).max()),
            float((topw[:, :top_k] - w).abs().max()))


def align_plain(topi: torch.Tensor, experts: int, bm: int):
    """Grouping and tile table of the flat ids ``topi`` [N, k] → (counts
    [E], offsets [E + 1], sorted_src [N·k], tile_expert, tile_start), all
    int32.  Rows keep their flat order within an expert; an id -1 (an
    expert not held) makes no grouped row, and ``sorted_src`` past
    ``offsets[E]`` is not read."""
    flat = topi.reshape(-1).long()
    kept = flat >= 0
    counts = torch.zeros(experts, dtype=torch.int64, device=flat.device)
    counts.index_add_(0, flat[kept], torch.ones_like(flat[kept]))
    offsets = torch.zeros(experts + 1, dtype=torch.int64, device=flat.device)
    offsets[1:] = torch.cumsum(counts, 0)
    sorted_src = torch.argsort(torch.where(kept, flat, experts), stable=True)
    tiles = (counts + bm - 1) // bm
    t_incl = torch.cumsum(tiles, 0)
    n_tiles = max_tiles(flat.numel(), experts, bm)
    t = torch.arange(n_tiles, device=flat.device)
    tile_expert = (t_incl[None, :] <= t[:, None]).sum(dim=1)      # E past the last
    e = tile_expert.clamp_max(experts - 1)
    tile_start = offsets[e] + (t - (t_incl - tiles)[e]) * bm
    as32 = lambda v: v.to(torch.int32)  # noqa: E731
    return (as32(counts), as32(offsets), as32(sorted_src), as32(tile_expert),
            as32(tile_start))


def _tiles(offsets, tile_expert, tile_start, experts: int, bm: int):
    """The live tiles on the host: (expert, first row, end row)."""
    for e, start in zip(tile_expert.tolist(), tile_start.tolist()):
        if e >= experts:
            continue
        yield e, start, min(start + bm, int(offsets[e + 1]))


def _w8a16_rows(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """r(x · qᵀ · s): the products summed in fp32, the scale applied in
    fp32, rounded once to x's dtype."""
    return ((x.float() @ q.float().T) * s.float()).to(x.dtype)


def _rows_of(w, e: int, lo: int, hi: int):
    """Expert ``e``'s rows ``[lo, hi)`` of an int8 ``{"q", "s"}`` stack or
    of a plain ``[E, R, C]`` stack → (q, s), s None for a plain one."""
    if isinstance(w, dict):
        return w["q"][e, lo:hi], w["s"][e, lo:hi]
    return w[e, lo:hi], None


def _product(x, q, s):
    return _w8a16_rows(x, q, s) if s is not None else \
        (x.float() @ q.float().T).to(x.dtype)


def gate_up_plain(x: torch.Tensor, sorted_src: torch.Tensor, offsets, tile_expert,
                  tile_start, w13, slots: int, bm: int) -> torch.Tensor:
    """Grouped gate and up with SiLU over the tile table → h [N·k, F] in
    grouped order (rows no tile reaches stay zero)."""
    q = w13["q"] if isinstance(w13, dict) else w13
    E, two_f = q.shape[0], q.shape[1]
    f = two_f // 2
    h = torch.zeros((sorted_src.numel(), f), dtype=x.dtype, device=x.device)
    for e, r0, r1 in _tiles(offsets, tile_expert, tile_start, E, bm):
        xs = x[sorted_src[r0:r1].long() // slots]
        g = _product(xs, *_rows_of(w13, e, 0, f))
        u = _product(xs, *_rows_of(w13, e, f, two_f))
        h[r0:r1] = F.silu(g.float()).to(x.dtype) * u
    return h


def down_plain(h: torch.Tensor, sorted_src: torch.Tensor, offsets, tile_expert,
               tile_start, w2, bm: int) -> torch.Tensor:
    """Grouped down over the tile table → y [N·k, D] at each row's flat
    (token, slot) index."""
    q = w2["q"] if isinstance(w2, dict) else w2
    E, d = q.shape[0], q.shape[1]
    y = torch.zeros((sorted_src.numel(), d), dtype=h.dtype, device=h.device)
    for e, r0, r1 in _tiles(offsets, tile_expert, tile_start, E, bm):
        y[sorted_src[r0:r1].long()] = _product(h[r0:r1], *_rows_of(w2, e, 0, d))
    return y


def combine_plain(y: torch.Tensor, topw: torch.Tensor, dtype) -> torch.Tensor:
    """``Σ_j w[t, j] · y[t·k + j]`` in fp32 (a slot of id -1 has no grouped
    row, and :func:`down_plain` leaves its row of y zero)."""
    n, k = topw.shape
    return (y.view(n, k, -1).float() * topw[..., None]).sum(dim=1).to(dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_COMBINE = None


def _combine_kernel():
    """Build the Triton combine (on first use: the module imports no
    ``triton``)."""
    global _COMBINE
    if _COMBINE is not None:
        return _COMBINE
    import triton
    import triton.language as tl

    @triton.jit
    def moe_combine(y_ptr, w_ptr, i_ptr, out_ptr, D, SLOTS: tl.constexpr,
                    BLOCK_D: tl.constexpr):
        # a slot of id -1 (an expert not held) has no row in y
        t = tl.program_id(0).to(tl.int64)
        d = tl.program_id(1) * BLOCK_D + tl.arange(0, BLOCK_D)
        dmask = d < D
        acc = tl.zeros((BLOCK_D,), dtype=tl.float32)
        for j in tl.static_range(SLOTS):
            w = tl.load(w_ptr + t * SLOTS + j)
            live = tl.load(i_ptr + t * SLOTS + j) >= 0
            yv = tl.load(y_ptr + (t * SLOTS + j) * D + d, mask=dmask & live, other=0.0)
            acc += w * yv.to(tl.float32)
        tl.store(out_ptr + t * D + d, acc.to(tl.bfloat16), mask=dmask)

    _COMBINE = (triton, moe_combine)
    return _COMBINE


def route(x: torch.Tensor, router: torch.Tensor, top_k: int, norm_topk: bool = False,
          scaling: float = 1.0, n_shared: int = 0, held=None, shared_gate: bool = False,
          score_bias=None):
    """The routing of ``routed_experts`` → (expert ids ``[N, top_k +
    n_shared]`` int32, weights fp32), the shared experts' slots last:
    ``moe_route`` for CUDA tensors (logits summed in another order than
    the plain version's, so a token whose k-th and next scores tie to fp32
    rounding may take the other), the plain version for CPU tensors.
    ``shared_gate``: the router's last row is the shared gate's.  ``held``
    (e0, n): routed ids become places among the held experts, -1 for the
    others; ``score_bias`` (fp32 ``[E]``): sigmoid routing (the module's
    docstring)."""
    E = router.shape[0] - int(bool(shared_gate))
    n_held = E if held is None else held[1]
    if x.device.type == "cpu":
        topi, topw = route_plain(x, router[:E], top_k, norm_topk, scaling, score_bias)
        gate = torch.sigmoid(x.float() @ router[E].float()) if shared_gate else None
        return with_shared(held_ids(topi, held), topw, n_held, n_shared, gate)
    from ospo_tpu_torch.ops import build

    n_tok, d = x.shape
    slots = top_k + n_shared
    e0 = 0 if held is None else held[0]
    if x.dtype != torch.bfloat16 or router.dtype != torch.bfloat16 \
            or not (x.is_contiguous() and router.is_contiguous()) or d % 32 \
            or router.dim() != 2 or router.shape[1] != d \
            or E > MAX_ROUTED or top_k > MAX_TOP_K or slots > 32 \
            or not (0 <= e0 and 0 < n_held and e0 + n_held <= E) \
            or (score_bias is not None and not (
                score_bias.dtype == torch.float32 and score_bias.is_contiguous()
                and score_bias.shape == (E,) and score_bias.device == x.device)):
        raise ValueError(f"moe_route: x {x.dtype} {tuple(x.shape)}, router "
                         f"{router.dtype} {tuple(router.shape)}, top-{top_k}, {slots} "
                         f"slots, held {held}; it takes contiguous bf16, D a multiple of "
                         f"32, at most {MAX_ROUTED} experts, top-{MAX_TOP_K} and 32 "
                         f"slots, a held range inside the routed experts, a correction "
                         f"bias of contiguous fp32 [E] on x's device")
    topi = torch.empty((n_tok, slots), dtype=torch.int32, device=x.device)
    topw = torch.empty((n_tok, slots), dtype=torch.float32, device=x.device)
    build.check(build.load("moe_experts").ospo_moe_route(
        x.data_ptr(), router.data_ptr(), None if score_bias is None else score_bias.data_ptr(),
        topi.data_ptr(), topw.data_ptr(), n_tok, d, E,
        top_k, n_shared, int(bool(norm_topk)), float(scaling), e0, n_held,
        int(bool(shared_gate)), torch.cuda.current_stream(x.device).cuda_stream),
        "moe_route")
    count_launch("moe_route")
    return topi, topw


def _check_cuda(x, router, w13, w2, counts, experts: int) -> None:
    if x.dtype != torch.bfloat16 or router.dtype != torch.bfloat16:
        raise ValueError(f"moe kernels: x {x.dtype}, router {router.dtype}; "
                         "they take bf16")
    for name, w in (("w13", w13), ("w2", w2)):
        if not (isinstance(w, dict) and w["q"].dtype == torch.int8
                and w["s"].dtype == torch.float32):
            raise ValueError(f"moe kernels: {name} must be int8 rows with fp32 "
                             "scales (quantize: int8)")
        for t in (w["q"], w["s"]):
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"moe kernels: {name} must be contiguous on "
                                 "x's device")
    d, f = x.shape[1], w13["q"].shape[1] // 2
    if d % 32 or f % 16:
        raise ValueError(f"moe kernels: D={d}, F={f}; they take D a multiple "
                         "of 32 and F of 16")
    shapes = {"w13 q": (experts, 2 * f, d), "w13 s": (experts, 2 * f),
              "w2 q": (experts, d, f), "w2 s": (experts, d)}
    got = {"w13 q": w13["q"].shape, "w13 s": w13["s"].shape, "w2 q": w2["q"].shape,
           "w2 s": w2["s"].shape}
    if any(tuple(got[n]) != want for n, want in shapes.items()) \
            or router.shape[1] != d:
        raise ValueError(f"moe kernels: x {tuple(x.shape)}, router "
                         f"{tuple(router.shape)}, {experts} experts held with the "
                         f"shared, { {n: tuple(v) for n, v in got.items()} }; they "
                         f"take {shapes} and the router [E, D]")
    if experts > MAX_EXPERTS:
        raise ValueError(f"moe kernels: {experts} experts; they take at most "
                         f"{MAX_EXPERTS}")
    if counts.dtype != torch.int32 or counts.device != x.device \
            or not counts.is_contiguous() or counts.numel() != experts:
        raise ValueError("moe kernels: counts must be contiguous int32 [experts] "
                         "on x's device")
    if not x.is_contiguous():
        raise ValueError("moe kernels: x must be contiguous")


def routed_experts(x: torch.Tensor, router: torch.Tensor, w13, w2, top_k: int,
                   counts: torch.Tensor, norm_topk: bool = False,
                   scaling: float = 1.0, n_shared: int = 0, held=None,
                   shared_gate: bool = False, score_bias=None) -> torch.Tensor:
    """The experts of the MoE FFN (the module's docstring) for tokens ``x
    [N, D]`` → ``[N, D]`` in x's dtype: the ``top_k`` routed ones and the
    ``n_shared`` shared ones that follow them in ``w13`` and ``w2``;
    ``held`` (e0, n) an expert share, ``shared_gate`` the router's last
    row gating the shared ones, ``score_bias`` sigmoid routing.  ``counts`` ``[held + n_shared]`` int32,
    zeroed by the caller, receives each expert's rows.  CUDA tensors launch
    the kernels; CPU tensors take the plain version."""
    n_tok, d = x.shape
    E = router.shape[0] - int(bool(shared_gate))
    slots = top_k + n_shared
    experts = (E if held is None else held[1]) + n_shared
    rows = n_tok * slots
    bm = block_m(rows, experts)
    cuda = x.device.type == "cuda"
    if cuda:
        _check_cuda(x, router, w13, w2, counts, experts)
    topi, topw = route(x, router, top_k, norm_topk, scaling, n_shared, held, shared_gate,
                       score_bias)
    if not cuda:
        c, offsets, src, tile_e, tile_s = align_plain(topi, experts, bm)
        counts.add_(c)
        h = gate_up_plain(x, src, offsets, tile_e, tile_s, w13, slots, bm)
        y = down_plain(h, src, offsets, tile_e, tile_s, w2, bm)
        return combine_plain(y, topw, x.dtype)
    from ospo_tpu_torch.ops import build

    lib = build.load("moe_experts")
    f = w13["q"].shape[1] // 2
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    i32 = dict(dtype=torch.int32, device=dev)
    n_tiles = max_tiles(rows, experts, bm)
    offsets = torch.empty((experts + 1,), **i32)
    src, rank = torch.empty((rows,), **i32), torch.empty((rows,), **i32)
    tile_e, tile_s = torch.empty((n_tiles,), **i32), torch.empty((n_tiles,), **i32)
    build.check(lib.ospo_moe_align(
        topi.data_ptr(), counts.data_ptr(), offsets.data_ptr(), src.data_ptr(),
        tile_e.data_ptr(), tile_s.data_ptr(), rank.data_ptr(), rows, experts, bm, n_tiles,
        stream), "moe_align")
    count_launch("moe_align")
    table = (src.data_ptr(), tile_e.data_ptr(), tile_s.data_ptr(), offsets.data_ptr())
    h = torch.empty((rows, f), dtype=x.dtype, device=dev)
    build.check(lib.ospo_moe_gate_up(
        x.data_ptr(), *table, w13["q"].data_ptr(), w13["s"].data_ptr(), h.data_ptr(),
        n_tiles, bm, d, f, experts, slots, stream), "moe_gate_up")
    count_launch("moe_gate_up")
    y = torch.empty((rows, d), dtype=x.dtype, device=dev)
    build.check(lib.ospo_moe_down(
        h.data_ptr(), *table, w2["q"].data_ptr(), w2["s"].data_ptr(), y.data_ptr(),
        n_tiles, bm, d, f, experts, stream), "moe_down")
    count_launch("moe_down")
    triton, combine = _combine_kernel()
    out = torch.empty((n_tok, d), dtype=x.dtype, device=x.device)
    combine[(n_tok, triton.cdiv(d, 1024))](y, topw, topi, out, d, SLOTS=slots,
                                           BLOCK_D=1024)
    count_launch("moe_combine")
    return out
