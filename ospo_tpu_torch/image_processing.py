"""Host-side image preprocessing (copy of ``ospo_tpu/image_processing.py``
without Pillow, which the GPU machine does not have).

``VLMImageProcessor`` semantics: resize the longest side to ``image_size``
(bicubic, antialias), pad to a square with the mean colour, rescale 1/255,
normalise (on the host in :meth:`ImageProcessor.process_one`, or on the
device for uint8 batches, ``ops/pixels.py``).  Images arrive as uint8
``[H, W, 3]`` arrays (``utils/png``).  :func:`pil_bicubic_resize` is
Pillow's ``Image.resize(size, BICUBIC)`` for RGB uint8 written out in numpy,
bit for bit (``tests/test_torch_vision.py`` holds it against Pillow).
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np

# the reference's VLMImageProcessor CLIP stats (image_processing_vlm.py:68-77);
# Janus-Pro checkpoints ship 0.5/0.5 in preprocessor_config.json
DEFAULT_MEAN = (0.48145466, 0.4578275, 0.40821073)
DEFAULT_STD = (0.26862954, 0.26130258, 0.27577711)


# Pillow's fixed-point resampling (libImaging/Resample.c): coefficients
# carry 22 fractional bits; 8-bit sums start at one half for rounding
PRECISION_BITS = 22


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel, a = -0.5, in float64, its operation order."""
    a = -0.5
    x = np.abs(x)
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    outer = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Taps of one pass (``precompute_coeffs`` + ``normalize_coeffs_8bpc``):
    → (source index [out, ksize], int64 fixed-point weight [out, ksize]),
    zero weight past each output's window.  The support widens by the
    reduction factor; weights are normalised in float64, then rounded half
    away from zero to 22 fractional bits."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size)
    count = xmax - xmin
    taps = np.arange(ksize)[None, :]
    live = taps < count[:, None]
    w = _bicubic(((taps + xmin[:, None]) - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):          # the C loop's summation order
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * (1 << PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed))
    idx = np.minimum(taps + xmin[:, None], in_size - 1)
    return idx, k.astype(np.int64)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass along ``axis`` (1: horizontal, 0: vertical) with a
    uint8 result, as Pillow's 8-bit passes store it."""
    idx, k = _coeffs(img.shape[axis], out_size)
    taps = np.take(img, idx, axis=axis).astype(np.int64)   # [.., out, ksize, ..]
    kk = k[:, :, None] if axis == 1 else k[:, :, None, None]
    acc = (taps * kk).sum(axis=axis + 1) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_bicubic_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(size, Image.BICUBIC)`` on RGB uint8 ``[H, W, 3]``;
    ``size`` is (width, height) as in PIL.  The horizontal pass, then the
    vertical one on its uint8 result, each skipped when its side is
    unchanged; a same-size call returns a copy."""
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _pass(out, w, axis=1)
    if h != img.shape[0]:
        out = _pass(out, h, axis=0)
    return out.copy() if out is img else out


def expand2square(img: np.ndarray, background_color) -> np.ndarray:
    """Pad to a square on the background colour, the image centred at
    ``((side - w) // 2, (side - h) // 2)`` as PIL's ``paste``."""
    h, w = img.shape[:2]
    if w == h:
        return img
    side = max(w, h)
    out = np.empty((side, side, 3), np.uint8)
    out[...] = np.asarray(background_color, np.uint8)
    y0, x0 = (side - h) // 2, (side - w) // 2
    out[y0:y0 + h, x0:x0 + w] = img
    return out


class ImageProcessor:
    def __init__(self, image_size: int = 384, min_size: int = 14,
                 image_mean: Sequence[float] = DEFAULT_MEAN,
                 image_std: Sequence[float] = DEFAULT_STD,
                 rescale_factor: float = 1.0 / 255.0,
                 do_normalize: bool = True):
        self.image_size = image_size
        self.min_size = min_size
        self.image_mean = tuple(image_mean)
        self.image_std = tuple(image_std)
        self.rescale_factor = rescale_factor
        self.do_normalize = do_normalize
        self.background_color = tuple(int(x * 255) for x in self.image_mean)

    @property
    def default_shape(self) -> Tuple[int, int, int]:
        """NHWC single-image shape."""
        return (self.image_size, self.image_size, 3)

    def resize(self, img: np.ndarray) -> np.ndarray:
        """Longest side to ``image_size`` (at least ``min_size`` each),
        bicubic, then padded to a square."""
        img = np.asarray(img)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected uint8 RGB [H, W, 3], got {img.dtype} "
                             f"{img.shape}")
        h, w = img.shape[:2]
        m = max(w, h)
        size = (max(int(w / m * self.image_size), self.min_size),
                max(int(h / m * self.image_size), self.min_size))
        return expand2square(pil_bicubic_resize(img, size),
                             self.background_color)

    def process_one(self, img: np.ndarray) -> np.ndarray:
        """→ float32 [H, W, 3], rescaled and normalised on the host."""
        arr = self.resize(img).astype(np.float32) * self.rescale_factor
        if self.do_normalize:
            arr = (arr - np.asarray(self.image_mean, np.float32)) / np.asarray(
                self.image_std, np.float32)
        return arr

    def process_one_u8(self, img: np.ndarray) -> np.ndarray:
        """Resize/pad only — rescale and normalize run on the device
        (``ops/pixels.normalize_pixels``)."""
        return self.resize(img)

    def __call__(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """→ [n_images, H, W, 3] float32 (possibly n_images == 0)."""
        if not len(images):
            return np.zeros((0, *self.default_shape), np.float32)
        return np.stack([self.process_one(im) for im in images])


def load_image_processor(model_path: Optional[str] = None,
                         image_size: int = 384) -> ImageProcessor:
    """Build from a checkpoint's ``preprocessor_config.json`` when present."""
    if model_path:
        cfg_path = os.path.join(model_path, "preprocessor_config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            return ImageProcessor(
                image_size=cfg.get("image_size", image_size),
                min_size=cfg.get("min_size", 14),
                image_mean=cfg.get("image_mean", DEFAULT_MEAN),
                image_std=cfg.get("image_std", DEFAULT_STD),
                rescale_factor=cfg.get("rescale_factor", 1.0 / 255.0),
                do_normalize=cfg.get("do_normalize", True),
            )
    return ImageProcessor(image_size=image_size)
