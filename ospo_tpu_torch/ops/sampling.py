"""Token sampling (counterpart of ``ospo_tpu/ops/sampling.py:17-20``).

torch and JAX draw different random numbers from the same seed, so the two
packages agree in distribution, never in token ids.
"""

from __future__ import annotations

import torch


def sample_categorical(logits: torch.Tensor, temperature: float,
                       generator: torch.Generator) -> torch.Tensor:
    """Temperature sampling over the last axis (Gumbel-max, as
    ``jax.random.categorical`` does); logits fp32 [..., V] → int64 [...].
    The temperature is floored at 1e-6."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits / max(float(temperature), 1e-6) + gumbel, dim=-1)
