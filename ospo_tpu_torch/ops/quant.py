"""Weight-only int8 quantization (W8A16) — the int8 subset of
``ospo_tpu/ops/quant.py`` (:25-75).

A quantized matrix is a dict ``{"q": int8 [..., F, D], "s": f32 [..., F]}``
with per-output-row symmetric scales (torch layout ``[out, in]``).
"""

from __future__ import annotations

from typing import Dict

import torch

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


def quantize_matrix(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., F, D] → {q: int8, s: f32 [..., F]} per-output-row symmetric.

    As in the reference, the division runs in the weight's dtype (the scale
    is cast to it first) and rounds half to even."""
    s = w.float().abs().amax(dim=-1) / 127.0
    s = s.clamp_min(1e-12)
    q = torch.round(w / s[..., None].to(w.dtype)).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantized_matmul(x: torch.Tensor, qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """y = x @ Wᵀ with W stored int8: the payload converted to x's dtype,
    then the per-row scale in x's dtype (``llama.py:207-209``)."""
    y = x @ qw["q"].to(x.dtype).T
    return y * qw["s"].to(x.dtype)
