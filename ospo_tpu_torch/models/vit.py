"""SigLIP vision transformer (the understanding tower) in PyTorch —
counterpart of ``ospo_tpu/models/vit.py``.

Janus runs the tower with ``ignore_head=True`` and ``select_feature="same"``:
the understanding path takes the post-norm patch tokens; the latent
attention-pool head that checkpoints carry is ported as
:func:`attention_pool` but not on that path.  No class token, learned
absolute position embedding over patches, LayerNorm eps 1e-6 with fp32
statistics, exact GELU in fp32.  ``select_layer`` truncates the depth as
``min(layers, layers + select_layer + 1)`` for non-positive values.

Parameters are a dict shaped like the JAX package's tree, blocks stacked on
a leading layer axis, linear weights ``[out, in]``; the patch embedding is
the checkpoint's OIHW convolution kernel (the JAX tree holds it HWIO).
Attention runs through ``ops/attention.attention`` with ``causal=False``:
at head dim 64 (SigLIP-L) the plain form, as on the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ospo_tpu_torch.ops.attention import attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 384
    patch_size: int = 16
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    select_layer: int = -1
    layer_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    @property
    def depth(self) -> int:
        """Effective depth after select_layer truncation."""
        if self.select_layer <= 0:
            return min(self.layers, self.layers + self.select_layer + 1)
        return min(self.layers, self.select_layer)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


# Janus-Pro understanding tower: SigLIP-Large/16 @384
SIGLIP_LARGE_384 = ViTConfig()
# SigLIP-so400m/14 @384 (the other tower the reference supports)
SIGLIP_SO400M_384 = ViTConfig(
    patch_size=14, width=1152, layers=27, heads=16, mlp_ratio=3.7362,
    select_layer=-1,
)


def tiny_vit_config(image_size=32, patch_size=16, width=32, layers=2, heads=2,
                    dtype=torch.float32) -> ViTConfig:
    return ViTConfig(image_size=image_size, patch_size=patch_size, width=width,
                     layers=layers, heads=heads, select_layer=-1, dtype=dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32 mean and (population) variance; the normalised value is cast to
    x's dtype before the affine part (``vit.py:109-114``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out.to(x.dtype) * scale + bias).to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w.T + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def patchify(p: Params, cfg: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] → [B, N, D] by the non-overlapping convolution (stride =
    patch), patches in row-major order."""
    x = pixels.to(cfg.dtype).permute(0, 3, 1, 2)
    out = F.conv2d(x, p["w"].to(cfg.dtype), stride=cfg.patch_size)
    out = out.flatten(2).transpose(1, 2)
    return out + p["b"]


def pos_embed(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x + params["pos_embed"].to(x.dtype)


def _block(x: torch.Tensor, bp: Params, cfg: ViTConfig) -> torch.Tensor:
    eps, h = cfg.layer_norm_eps, cfg.heads
    b, n, d = x.shape
    hidd = layer_norm(x, bp["norm1_scale"], bp["norm1_bias"], eps)
    qkv = _linear(hidd, bp["wqkv"], bp["bqkv"]).view(b, n, 3, h, d // h)
    att = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask=None,
                    causal=False)
    x = x + _linear(att.reshape(b, n, d), bp["wo"], bp["bo"])
    hidd = layer_norm(x, bp["norm2_scale"], bp["norm2_bias"], eps)
    hidd = _gelu(_linear(hidd, bp["w1"], bp["b1"]))
    return x + _linear(hidd, bp["w2"], bp["b2"])


def forward(params: Params, cfg: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] (already normalised) → patch features [B, N, D]."""
    x = pos_embed(params, patchify(params["patch_embed"], cfg, pixels))
    blocks = params["blocks"]
    for li in range(blocks["wqkv"].shape[0]):
        x = _block(x, {k: t[li] for k, t in blocks.items()}, cfg)
    fn = params["final_norm"]
    return layer_norm(x, fn["scale"], fn["bias"], cfg.layer_norm_eps)


def attention_pool(params: Params, cfg: ViTConfig,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Latent-query attention pooling (timm ``AttentionPoolLatent``):
    [B, N, D] → [B, D] (``vit.py:187-206``)."""
    b, n, d = tokens.shape
    h = cfg.heads
    latent = params["latent"].expand(b, 1, d)
    q = _linear(latent, params["q"]["w"], params["q"]["b"]).view(b, 1, h, d // h)
    kv = _linear(tokens, params["kv"]["w"], params["kv"]["b"]).view(
        b, n, 2, h, d // h)
    att = attention(q, kv[:, :, 0], kv[:, :, 1], mask=None, causal=False)
    x = _linear(att.reshape(b, 1, d), params["proj"]["w"], params["proj"]["b"])
    hmid = layer_norm(x, params["norm"]["scale"], params["norm"]["bias"],
                      cfg.layer_norm_eps)
    hmid = _gelu(_linear(hmid, params["fc1"]["w"], params["fc1"]["b"]))
    x = x + _linear(hmid, params["fc2"]["w"], params["fc2"]["b"])
    return x[:, 0]
