"""Group-wise int4 weights for the reference, rounded as a program that
quantizes with ``quantize: int4g`` rounds them.

Each output row of a projection is cut into groups of ``group`` contiguous
input columns (the group clamps to the row's width, and must then divide
it); a group's scale is its largest magnitude over 7 in float32 (at least
1e-12), the quotient of each weight by that scale is taken in the model's
dtype, rounded half to even and clamped to ±7, and the weight the program
computes with stands for the quotient times the float32 scale.  These are
the weights ``reference/janus.py``'s ``cfg_logits`` reads when handed them
with its own rounding off (``weight_levels`` None).
"""

from __future__ import annotations

from typing import Dict

import torch

from reference.janus import PROJ, Weights, model_dtype


def round_int4_group(wt: torch.Tensor, group: int) -> torch.Tensor:
    """A matrix ``[F, D]`` in the model's dtype → the float32 matrix its
    group-wise int4 form stands for."""
    f, d = wt.shape
    group = min(group, d)
    if d % group:
        raise ValueError(f"int4 groups of {group} do not divide the in dim {d}")
    wg = wt.reshape(f, d // group, group)
    s = (wg.float().abs().amax(dim=-1) / 7.0).clamp_min(1e-12)
    q = torch.round(wg / s[..., None].to(wt.dtype)).clamp(-7, 7)
    return (q.float() * s[..., None]).reshape(f, d)


def weights(w: Weights, cfg: dict, group: int) -> Dict[str, torch.Tensor]:
    """``w`` with every trunk projection (each layer's q, k, v, o, gate, up
    and down) replaced by its group-wise int4 matrix in float32."""
    out = dict(w)
    dt = model_dtype(cfg)
    for li in range(cfg["language_config"]["num_hidden_layers"]):
        for hf in PROJ.values():
            key = f"language_model.model.layers.{li}.{hf}.weight"
            out[key] = round_int4_group(w[key].to(dt), group)
    return out
