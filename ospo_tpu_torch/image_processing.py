"""Host-side image preprocessing (copy of ``ospo_tpu/image_processing.py``
without Pillow, which the GPU machine does not have).

``VLMImageProcessor`` semantics: resize the longest side to ``image_size``
(bicubic, antialias), pad to a square with the mean colour, rescale 1/255,
normalise (on the device, ``ops/pixels.py``).  Images arrive as uint8
``[H, W, 3]`` arrays (``utils/png``).
An image that is already ``image_size`` × ``image_size`` passes through
unchanged, as it does through PIL's same-size ``resize`` and
``expand2square``; any other size raises: the PIL-exact bicubic resize is
queued in ROADMAP.md with the understanding slice.  Step 3 writes images at
the processor's size, so step 5 never resizes.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

# the reference's VLMImageProcessor CLIP stats (image_processing_vlm.py:68-77);
# Janus-Pro checkpoints ship 0.5/0.5 in preprocessor_config.json
DEFAULT_MEAN = (0.48145466, 0.4578275, 0.40821073)
DEFAULT_STD = (0.26862954, 0.26130258, 0.27577711)


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

    def resize(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected uint8 RGB [H, W, 3], got {img.dtype} "
                             f"{img.shape}")
        if img.shape[:2] != (self.image_size, self.image_size):
            raise NotImplementedError(
                f"image of {img.shape[1]}x{img.shape[0]} px: only "
                f"{self.image_size}x{self.image_size} images pass unchanged; "
                "the PIL-exact bicubic resize is queued in ROADMAP.md "
                "(understanding slice)")
        return img

    def process_one_u8(self, img: np.ndarray) -> np.ndarray:
        """Resize/pad only — rescale and normalize run on the device
        (``ops/pixels.normalize_pixels``)."""
        return self.resize(img)


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
