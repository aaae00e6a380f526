"""Pixel normalization on the device for uint8-transferred images —
counterpart of ``ospo_tpu/ops/pixels.py`` (:25-36).  Train batches travel
as uint8 (4× fewer bytes than host-normalized float32) and are rescaled and
normalized here, in fp32 with the same constants and operation order as the
JAX function."""

from __future__ import annotations

import torch


def normalize_pixels(x: torch.Tensor, image_processor,
                     dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] → normalized ``dtype`` pixels; float input
    passes through unchanged (already host-normalized)."""
    if x.dtype != torch.uint8:
        return x
    ip = image_processor
    const = lambda v: torch.tensor(v, dtype=dtype, device=x.device)  # noqa: E731
    x = x.to(dtype) * const(ip.rescale_factor)
    if ip.do_normalize:
        x = (x - const(ip.image_mean)) / const(ip.image_std)
    return x
