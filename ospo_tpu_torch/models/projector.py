"""MLP projector and image-token head (counterpart of
``ospo_tpu/models/projector.py``): ``mlp_gelu`` = Linear, then (depth − 1) ×
[GELU, Linear]; ``vision_head`` = Linear → GELU → Linear, fp32 logits.
GELU is exact (erf) and computed in fp32 (``projector.py:39-40``)."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ospo_tpu_torch.models.llama import linear

Params = Dict[str, Any]


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(x, p["w"]) + p["b"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def mlp_projector(params: Params, x: torch.Tensor) -> torch.Tensor:
    layers = params["layers"]
    x = _linear(layers[0], x)
    for lp in layers[1:]:
        x = _linear(lp, _gelu(x))
    return x


def vision_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Hidden states → image-token logits (fp32)."""
    x = _gelu(_linear(params["proj"], x))
    return _linear(params["head"], x).float()
