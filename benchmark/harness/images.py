"""Seeded input images: smooth RGB pictures made on the device (uniform
noise on a 12x12 grid, bilinearly upsampled), written as PNGs."""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from reference import png


def make_pool(n: int, side: int, seed: int, device) -> List[np.ndarray]:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    low = torch.rand((n, 3, 12, 12), generator=gen, device=device)
    img = F.interpolate(low, size=(side, side), mode="bilinear", align_corners=False)
    return list((img * 255).round().clamp(0, 255).to(torch.uint8)
                .permute(0, 2, 3, 1).cpu().numpy())


def write_pool(directory: str, n: int, side: int, seed: int, device) -> List[str]:
    """``n`` images under ``directory`` → their paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, img in enumerate(make_pool(n, side, seed, device)):
        paths.append(os.path.join(directory, f"{i:03d}.png"))
        png.write(paths[-1], img)
    return paths
