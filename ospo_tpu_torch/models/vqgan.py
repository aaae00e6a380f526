"""VQ-GAN tokenizer (encode side, step 5) and detokenizer (decode side,
step 3) in PyTorch — counterpart of ``ospo_tpu/models/vqgan.py``.

Runs NCHW with OIHW convolution weights, in fp32 throughout; the public
:func:`encode_to_ids` and :func:`decode_code` take and return NHWC pixels
like the JAX functions.  On the GPU both run with TF32 off, so convolutions
and the codebook product keep full fp32 as in the reference.
The attention block at the lowest resolution is a plain product
(``torch.matmul``), as the reference leaves it to the compiler.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VQConfig:
    codebook_size: int = 16384
    codebook_dim: int = 8
    base_ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 256
    l2_norm_codebook: bool = True

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


VQ_16 = VQConfig()


def tiny_vq_config(codebook_size: int = 64, codebook_dim: int = 8,
                   base_ch: int = 16, ch_mult: Tuple[int, ...] = (1, 2),
                   z_channels: int = 16) -> VQConfig:
    return VQConfig(codebook_size=codebook_size, codebook_dim=codebook_dim,
                    base_ch=base_ch, ch_mult=ch_mult, z_channels=z_channels)


# ---------------------------------------------------------------------------
# building blocks (NCHW, fp32)
# ---------------------------------------------------------------------------


def conv2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' convolution with an OIHW kernel."""
    k = p["w"].shape[-1]
    return F.conv2d(x, p["w"], p["b"], padding=k // 2)


def group_norm(p: Params, x: torch.Tensor, groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm, population variance, eps 1e-6 (``vqgan.py:195-202``)."""
    return F.group_norm(x, min(groups, x.shape[1]), p["scale"], p["bias"], eps)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def res_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv1"], swish(group_norm(p["norm1"], x)))
    h = conv2d(p["conv2"], swish(group_norm(p["norm2"], h)))
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def attn_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    hn = group_norm(p["norm"], x)
    q = conv2d(p["q"], hn).reshape(n, c, h * w).transpose(1, 2)   # [n, hw, c]
    k = conv2d(p["k"], hn).reshape(n, c, h * w)                   # [n, c, hw]
    v = conv2d(p["v"], hn).reshape(n, c, h * w).transpose(1, 2)
    probs = torch.softmax(torch.matmul(q, k) * c ** -0.5, dim=-1)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(n, c, h, w)
    return x + conv2d(p["proj_out"], out)


def upsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = F.interpolate(x, scale_factor=2, mode="nearest")  # nearest ×2
    return conv2d(p, x)


def downsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Pad (left 0, right 1, top 0, bottom 1), then a stride-2 valid
    convolution (``vqgan.py:229-232``)."""
    x = F.pad(x, (0, 1, 0, 1))
    return F.conv2d(x, p["w"], p["b"], stride=2)


def encoder_forward(p: Params, cfg: VQConfig, x: torch.Tensor) -> torch.Tensor:
    """NCHW pixels → NCHW latents (``vqgan.py:246-260``)."""
    h = conv2d(p["conv_in"], x)
    n_levels = len(cfg.ch_mult)
    for i, level in enumerate(p["levels"]):
        for j, rp in enumerate(level["res"]):
            h = res_block(rp, h)
            if level["attn"]:
                h = attn_block(level["attn"][j], h)
        if i != n_levels - 1:
            h = downsample(level["downsample"], h)
    h = res_block(p["mid"][0], h)
    h = attn_block(p["mid"][1], h)
    h = res_block(p["mid"][2], h)
    return conv2d(p["conv_out"], swish(group_norm(p["norm_out"], h)))


def decoder_forward(p: Params, cfg: VQConfig, z: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv_in"], z)
    h = res_block(p["mid"][0], h)
    h = attn_block(p["mid"][1], h)
    h = res_block(p["mid"][2], h)
    n_levels = len(cfg.ch_mult)
    for idx, level in enumerate(p["levels"]):
        for j, rp in enumerate(level["res"]):
            h = res_block(rp, h)
            if level["attn"]:
                h = attn_block(level["attn"][j], h)
        if idx != n_levels - 1:
            h = upsample(level["upsample"], h)
    return conv2d(p["conv_out"], swish(group_norm(p["norm_out"], h)))


def normalized_codebook(params: Params, cfg: VQConfig) -> torch.Tensor:
    cb = params["codebook"]
    if cfg.l2_norm_codebook:
        cb = cb / torch.linalg.vector_norm(cb, dim=-1, keepdim=True)
    return cb


def _nearest_code(params: Params, cfg: VQConfig, z: torch.Tensor):
    """z NHWC → (zn, looked-up codes NHWC, flat ids): argmin over the
    codebook of ‖z‖² − 2 z·e + ‖e‖² in fp32 (``vqgan.py:287-303``)."""
    cb = normalized_codebook(params, cfg)
    zn = z
    if cfg.l2_norm_codebook:
        zn = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-12)
    flat = zn.reshape(-1, zn.shape[-1])
    dots = flat @ cb.T
    d = (flat * flat).sum(dim=-1, keepdim=True) - 2 * dots + (cb * cb).sum(dim=-1)
    ids = torch.argmin(d, dim=-1)
    return zn, cb[ids].reshape(zn.shape), ids


def quantize(params: Params, cfg: VQConfig, z: torch.Tensor):
    """Nearest-codebook lookup. z NHWC [B, h, w, Cd] → (z_q, ids [B, h, w]);
    the straight-through z_q passes gradients to the normalised z."""
    zn, z_q_raw, ids = _nearest_code(params, cfg, z)
    return zn + (z_q_raw - zn).detach(), ids.reshape(z.shape[:-1])


def encode(params: Params, cfg: VQConfig, pixels: torch.Tensor):
    """NHWC pixels in [-1, 1] → (z_q NHWC, ids [B, h, w]); convolutions and
    the codebook product in full fp32 (TF32 off on the GPU)."""
    x = pixels.float().permute(0, 3, 1, 2).contiguous()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            h = encoder_forward(params["encoder"], cfg, x)
            z = conv2d(params["quant_conv"], h)
        return quantize(params, cfg, z.permute(0, 2, 3, 1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def encode_to_ids(params: Params, cfg: VQConfig, pixels: torch.Tensor) -> torch.Tensor:
    """The step-5 hot path: images → flat codebook ids [B, h*w]
    (``vqgan.py:354-358``)."""
    _, ids = encode(params, cfg, pixels)
    return ids.reshape(ids.shape[0], -1)


def decode(params: Params, cfg: VQConfig, z_q: torch.Tensor) -> torch.Tensor:
    """z_q NCHW → pixels NCHW."""
    z = conv2d(params["post_quant_conv"], z_q)
    return decoder_forward(params["decoder"], cfg, z)


def decode_code(params: Params, cfg: VQConfig, ids: torch.Tensor,
                latent_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Codebook ids [B, N] or [B, h, w] → NHWC float pixels in about
    [-1, 1] (``vqgan.py:366-380``)."""
    if ids.ndim == 2:
        if latent_hw is None:
            side = int(round(ids.shape[1] ** 0.5))
            latent_hw = (side, side)
        ids = ids.reshape(ids.shape[0], *latent_hw)
    z_q = normalized_codebook(params, cfg)[ids].permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        pixels = decode(params, cfg, z_q.contiguous())
    return pixels.permute(0, 2, 3, 1)
