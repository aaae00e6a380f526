"""Token sampling (counterpart of ``ospo_tpu/ops/sampling.py``).

torch and JAX draw different random numbers from the same seed, so the two
packages agree in distribution, never in sampled token ids; greedy
decoding (``argmax``, the first maximum in both) agrees exactly.  Every draw
takes an explicit ``torch.Generator`` on the device of the logits.
"""

from __future__ import annotations

from typing import Optional

import torch

# candidates of the nucleus sampler: the nucleus is cut inside the TOP_P_K
# highest logits (``ospo_tpu/ops/sampling.py:48-79``, its default k)
TOP_P_K = 64


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


def _nucleus_keep(sorted_probs: torch.Tensor, top_p: float) -> torch.Tensor:
    """HF's index-based cutoff over probabilities in descending order: keep
    while the mass strictly before a position is < top_p; the top-ranked
    position is always kept."""
    keep = (torch.cumsum(sorted_probs, dim=-1) - sorted_probs) < top_p
    keep[..., 0] = True
    return keep


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Exact nucleus filter over the full vocabulary: logits outside the
    nucleus → -inf.  The keep mask is by index through a stable sort, so
    logits tied with the cutoff are not all kept
    (``ospo_tpu/ops/sampling.py:23-45``)."""
    sorted_idx = torch.argsort(-logits, dim=-1, stable=True)
    sorted_probs = torch.softmax(torch.gather(logits, -1, sorted_idx), dim=-1)
    keep = torch.empty_like(sorted_idx, dtype=torch.bool).scatter_(
        -1, sorted_idx, _nucleus_keep(sorted_probs, top_p))
    return torch.where(keep, logits, torch.full_like(logits, float("-inf")))


def nucleus_topk(scaled_logits: torch.Tensor, top_p: float, k: int):
    """The candidates of :func:`top_p_sample_topk`: the ``k`` highest
    logits, those outside the nucleus set to -inf, and their token ids.
    Each candidate's probability is taken against the full-vocabulary
    ``logsumexp`` and the HF cutoff is applied within the candidates."""
    k = min(int(k), scaled_logits.shape[-1])
    vals, idx = torch.topk(scaled_logits, k, dim=-1)             # descending
    lse = torch.logsumexp(scaled_logits, dim=-1, keepdim=True)
    keep = _nucleus_keep(torch.exp(vals - lse), top_p)
    return torch.where(keep, vals, torch.full_like(vals, float("-inf"))), idx


def top_p_sample_topk(scaled_logits: torch.Tensor, top_p: float, k: int,
                      generator: torch.Generator) -> torch.Tensor:
    """Nucleus sampling inside the ``k`` highest logits: equal to the exact
    filter whenever the nucleus fits in the top ``k``; otherwise it samples
    the top ``k`` (``ospo_tpu/ops/sampling.py:48-79``)."""
    vals, idx = nucleus_topk(scaled_logits, top_p, k)
    choice = sample_categorical(vals, 1.0, generator)
    return torch.gather(idx, -1, choice[..., None])[..., 0]


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature: float = 1.0, top_p: Optional[float] = None,
                 do_sample: bool = True) -> torch.Tensor:
    """One sampling step, logits fp32 [..., V] → int64 token ids [...]:
    ``argmax`` when not sampling; else temperature, then the top-k nucleus
    sampler when ``top_p`` < 1, plain categorical otherwise
    (``ospo_tpu/ops/sampling.py:82-103``)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(float(temperature), 1e-6)
    if top_p is not None and top_p < 1.0:
        return top_p_sample_topk(scaled, top_p, TOP_P_K, generator)
    return sample_categorical(scaled, 1.0, generator)
