"""The tolerance that the suffix-attention kernel (``ops/suffix_attention.py``)
is held to against its plain version, and a model of the kernel's one extra
rounding, for ``tests/test_torch_suffix_attention.py`` (CPU) and
``tests/test_torch_cuda.py`` (the card).

The kernel computes the plain version's function with one rounding more:
for the int8 rows, ``p * v_scale / f`` goes to fp16 before P . V (f a power
of two at or above the v scales, so fp16's relative step 2^-11 applies
down to 2^-14 f).  The error that adds to an output element (t, d) is
``sum_j e_j * p_j * w_j * v_jd`` with independent ``|e_j| <= 2^-11``
(uniform, RMS 2^-11 / sqrt 3), so its RMS is ``2^-11 / sqrt 3 * R`` where
``R = sqrt(sum_j (p_j w_j v_jd)^2)`` (p normalised, w the v scale, 1 for a
bf16 value).  Where one key dominates, the error is at most ``2^-11 R``.
The tolerance of an element is

    bf16_step(|ref|)                 the kernel's own rounding to bf16
    + 2^-9 * R                       ~6.9 RMS of the fp16 rounding of P
    + 2^-16 * sum_j |p_j w_j v_jd|   fp32 sums in another order; the bf16
                                     rows' p as hi + lo (2^-18 relative)
    + 2^-24 * max_j p_j * max_j w_j * sum_j |v_jd|
                                     fp16's absolute step below 2^-14 f

where ``ref`` is the plain version in fp32 (q passed as fp32, so it is not
rounded to bf16 at the end).
"""

from __future__ import annotations

import torch

from ospo_tpu_torch.ops.suffix_attention import suffix_attention_plain

NEG_FILL = -1e30


def bf16_step(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v| (fp32): 2^(floor(log2 |v|) - 7)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _terms(q, k_cache, v_cache, layer, cur_len, mask, pk, pv, pm, ks, vs):
    """The plain version's normalised probabilities ``[B, H, T, C + W]``, the
    values they weigh ``[B, H, C + W, Dh]`` (v scale folded in), the own
    values alone ``[B, H, W, Dh]`` and their v scales ``[B, H, W]``."""
    B, T, H, dh = q.shape
    W = cur_len + T
    qf = q.float().transpose(1, 2)                                # [B, H, T, dh]
    k = k_cache[layer, :W].float().permute(2, 1, 0, 3)            # [B, H, W, dh]
    v = v_cache[layer, :W].float().permute(2, 1, 0, 3)
    s = (qf @ k.transpose(-1, -2)) * dh ** -0.5
    if ks is None:
        w = torch.ones((B, H, W), device=q.device)
    else:
        s = s * ks[layer, :W].permute(2, 1, 0)[:, :, None, :]
        w = vs[layer, :W].permute(2, 1, 0)
    rows = cur_len + torch.arange(T, device=q.device)[:, None]
    ok = (mask[:, None, None, :W] != 0) & (torch.arange(W, device=q.device) <= rows)
    s = torch.where(ok, s, torch.full_like(s, NEG_FILL))
    vals = v * w[..., None]
    if pk is not None:
        C = pk.shape[0]
        sp = (qf @ pk.float().permute(1, 2, 0)) * dh ** -0.5       # [B, H, T, C]
        pmask = torch.ones((1, C), dtype=torch.bool) if pm is None else (pm != 0)
        pmask = pmask.reshape(-1, C).to(q.device)
        sp = torch.where(pmask[:, None, None, :], sp, torch.full_like(sp, NEG_FILL))
        s = torch.cat([sp, s], dim=-1)
        vals = torch.cat([pv.float().permute(1, 0, 2)[None].expand(B, H, C, dh), vals], 2)
    return torch.softmax(s, dim=-1), vals, v, w


def plain_and_tolerance(q, k_cache, v_cache, layer, cur_len, mask, pk=None, pv=None,
                        pm=None, ks=None, vs=None):
    """(the plain version in fp32 ``[B, T, H, dh]``, each element's
    tolerance)."""
    ref = suffix_attention_plain(q.float(), k_cache, v_cache, layer, cur_len, mask,
                                 pk, pv, pm, ks, vs)
    probs, vals, v, w = _terms(q, k_cache, v_cache, layer, cur_len, mask, pk, pv,
                               pm, ks, vs)
    r = torch.sqrt((probs * probs) @ (vals * vals))
    a = probs @ vals.abs()
    floor = (2.0 ** -24 * probs.amax(-1, keepdim=True) * w.amax(-1)[..., None, None]
             * v.abs().sum(2)[:, :, None, :])
    tol = 2.0 ** -9 * r + 2.0 ** -16 * a + floor                  # [B, H, T, dh]
    return ref, bf16_step(ref) + tol.transpose(1, 2)


def fp16_p_model(q, k_cache, v_cache, layer, cur_len, mask, pk=None, pv=None, pm=None,
                 ks=None, vs=None):
    """The plain version in fp32 with the kernel's extra rounding: each int8
    row's ``p * v_scale / f`` rounded to fp16, f the power of two above the
    (b, h) window's largest v scale, p the unnormalised probability."""
    probs, vals, v, w = _terms(q, k_cache, v_cache, layer, cur_len, mask, pk, pv,
                               pm, ks, vs)
    C = probs.shape[-1] - v.shape[2]
    pmax = probs.amax(-1, keepdim=True)
    f = torch.exp2(torch.floor(torch.log2(w.amax(-1))) + 1)[..., None, None]
    own = (probs[..., C:] / pmax * w[:, :, None, :] / f).half().float()
    own = own * f * pmax
    out = own @ v + probs[..., :C] @ vals[:, :, :C]
    return out.transpose(1, 2)


def suffix_inputs(B, T, H, cur_len, C, kind, seed, device, prefix_mask="shared",
                  masked_row=True):
    """The kernel's arguments as step 4b makes them, layer 1 of 2 (layer 0
    and the rows past the window hold values that must not be read):
    ``kind`` ``"int8"`` (rows quantized per (row, head), fp32 scales) or
    ``"bf16"``; left-padded image rows and suffix rows (image 0 unpadded);
    q at twice the unit scale (scores of spread ~2); a prefix of ``C`` rows,
    its mask ``"shared"`` ``[1, C]`` (5 left-pad rows) or ``"per_image"``
    ``[B, C]`` (ragged left pads).  ``masked_row``: image 1's keys
    ``[0, cur_len + 5)`` masked (and its prefix row, per image), so its
    first suffix rows have no allowed key.  → dict of the kernel's keyword
    arguments."""
    from ospo_tpu_torch.ops.layer_tail import quantize_rows

    g = torch.Generator(device=device).manual_seed(seed)
    dh, L, S = 128, 2, cur_len + T + 8
    W = cur_len + T

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    def pads(n, hi):
        p = torch.randint(0, hi, (n,), generator=g, device=device)
        p[0] = 0
        return p

    q = randn(B, T, H, dh, scale=2.0).to(torch.bfloat16)
    rows = {n: randn(L, S, H, B, dh) for n in ("k", "v")}
    for x in rows.values():             # rows past the window: loud if read
        x[:, W:] = 1e3
    args = dict(q=q, layer_idx=1, cur_len=cur_len)
    for n, x in rows.items():
        if kind == "int8":
            xq, xs = quantize_rows(x)
            args[n + "_cache"], args[n[0] + "_scale"] = xq, xs.contiguous()
        else:
            args[n + "_cache"] = x.to(torch.bfloat16)
    cols = torch.arange(S, device=device)
    img_pad = pads(B, 64)[:, None]
    sfx_pad = pads(B, T // 2 + 1)[:, None]
    mask = ((cols >= img_pad) & ((cols < cur_len) | (cols >= cur_len + sfx_pad)))
    if masked_row:
        mask[1, :cur_len + 5] = False
    args["mask"] = mask.to(torch.int32)
    if C:
        args["prefix_k"], args["prefix_v"] = (randn(C, H, dh).to(torch.bfloat16)
                                              for _ in range(2))
        c = torch.arange(C, device=device)
        if prefix_mask == "shared":
            pm = (c >= 5)[None]
        else:
            pm = c[None, :] >= pads(B, C)[:, None]
            if masked_row:
                pm[1] = False
        args["prefix_mask"] = pm.to(torch.int32)
    return args


def call(fn, a, **changes):
    """``fn`` (the kernel's wrapper or a plain version of the same
    arguments) on the arguments ``a`` with ``changes``."""
    a = {**a, **changes}
    return fn(a["q"], a["k_cache"], a["v_cache"], a["layer_idx"], a["cur_len"], a["mask"],
              a.get("prefix_k"), a.get("prefix_v"), a.get("prefix_mask"),
              a.get("k_scale"), a.get("v_scale"))


def controls(a):
    """The three changes a right result must not survive: one image's k
    scales (int8) or k rows (bf16) times 1 + 2^-7, the prefix dropped, the
    causal limit one row lower (``cur_len - 1``)."""
    out = {}
    if "k_scale" in a:
        ks = a["k_scale"].clone()
        ks[..., 2] *= 1 + 2 ** -7
        out["k_scale"] = {"k_scale": ks}
    if "prefix_k" in a:
        out["prefix"] = {"prefix_k": None, "prefix_v": None, "prefix_mask": None}
    out["causal"] = {"cur_len": a["cur_len"] - 1}
    return out


def worst(got, ref, tol) -> float:
    """max |got - ref| / tol over every element."""
    return float(((got.float() - ref) / tol).abs().max())
