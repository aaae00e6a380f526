"""Optimizer and LR schedules — counterpart of ``ospo_tpu/train/optim.py``.

The JAX package's optax chain, written out: ``clip_by_global_norm`` →
fp32 cast → ``adamw`` (fp32 moments, bias correction, eps outside the
square root, decoupled weight decay scaled by the LR), optionally wrapped
in ``MultiSteps`` (the running mean of k micro-gradients, applied on the
k-th).  ``torch.optim.AdamW`` and ``clip_grad_norm_`` differ in small ways
(the latter adds 1e-6 to the norm), so neither is used.  Updates are
in place on the parameter tensors (the LoRA adapters, or in full mode the
trained submodules) and never read a tensor back to the host.

Schedules (``optim.py:35-93``): ``constant``, ``cosine``
(CosineDecayWarmUpRestarts: linear warmup, one cosine decay to ``min_lr``)
and ``cosine_restarts`` (SGDR warm restarts).  As in optax, the schedule is
evaluated at the number of updates applied before the current one.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch


def cosine_decay_warmup(init_lr: float, warmup_steps: int, max_steps: int,
                        min_lr: float = 1e-6) -> Callable[[int], float]:
    """Linear warmup to ``init_lr`` then cosine decay to ``min_lr``."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return init_lr * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps)
                           / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + (init_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * progress))

    return schedule


def cosine_annealing_warmup_restarts(first_cycle_steps: int, max_lr: float,
                                     min_lr: float = 1e-6,
                                     warmup_steps: int = 0,
                                     cycle_mult: float = 1.0,
                                     gamma: float = 1.0
                                     ) -> Callable[[int], float]:
    """SGDR warm restarts with per-cycle linear warmup and peak decay."""

    def schedule(step: int) -> float:
        step = float(step)
        if cycle_mult == 1.0:
            cycle = math.floor(step / first_cycle_steps)
            in_cycle = step - cycle * first_cycle_steps
            cycle_steps = float(first_cycle_steps)
        else:
            cycle = math.floor(math.log(step / first_cycle_steps
                                        * (cycle_mult - 1) + 1)
                               / math.log(cycle_mult))
            start = first_cycle_steps * (cycle_mult ** cycle - 1) / (cycle_mult - 1)
            in_cycle = step - start
            cycle_steps = first_cycle_steps * cycle_mult ** cycle
        peak = max_lr * gamma ** cycle
        if in_cycle < warmup_steps:
            return (peak - min_lr) * in_cycle / max(warmup_steps, 1) + min_lr
        progress = min(max((in_cycle - warmup_steps)
                           / max(cycle_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + (peak - min_lr) * 0.5 * (1 + math.cos(math.pi * progress))

    return schedule


def make_schedule(scheduler_type: str, init_lr: float, max_steps: int,
                  warmup_ratio: float = 0.0, min_lr: float = 1e-6
                  ) -> Callable[[int], float]:
    warmup = int(max_steps * warmup_ratio)
    if scheduler_type == "constant":
        return lambda step: init_lr
    if scheduler_type == "cosine":
        return cosine_decay_warmup(init_lr, warmup, max_steps, min_lr)
    if scheduler_type == "cosine_restarts":
        return cosine_annealing_warmup_restarts(
            first_cycle_steps=max_steps, max_lr=init_lr, min_lr=min_lr,
            warmup_steps=warmup)
    raise ValueError(f"unknown scheduler_type: {scheduler_type}")


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a nested dict / list tree, paths
    keyed as the checkpoints key them (``q_proj/a``, ``levels/[0]/w``)."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves(v, f"{prefix}[{i}]/")]
    return [(prefix[:-1], tree)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for _, t in leaves(tree)))


class AdamW:
    """clip → fp32 → AdamW, optionally accumulated over ``accumulation_steps``
    micro-batches.  ``step(params, grads)`` updates ``params`` (any nested
    tree of tensors; ``grads`` of the same structure) in place and returns
    whether an update was applied.  ``norm`` is the clip's global norm of a
    flat ``{path: gradient}`` dict (:func:`global_norm`; a tensor-parallel
    trainer's counts each sharded leaf over the model group).

    The moments and the update are fp32 whatever the parameter dtype, and
    the update is added in fp32 and rounded once to the parameter's dtype:
    optax's ``adamw(mu_dtype=float32)`` behind the fp32 cast and
    ``apply_updates`` (``ospo_tpu/train/optim.py:120-139``).  No fp32
    master copy of the parameters is kept, as in the JAX package."""

    def __init__(self, params, schedule: Callable[[int], float],
                 betas=(0.9, 0.95), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: Optional[float] = 1.0,
                 accumulation_steps: int = 1,
                 norm: Callable[[Dict], torch.Tensor] = global_norm):
        self.schedule = schedule
        self.norm = norm
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.grad_clip = float(grad_clip) if grad_clip else None
        self.k = max(int(accumulation_steps or 1), 1)
        self.count = 0       # updates applied
        self.mini_step = 0   # micro-batches accumulated toward the next one
        shapes = leaves(params)
        zeros = lambda: {k: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
                         for k, t in shapes}
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if self.k > 1 else None

    @torch.no_grad()
    def step(self, params, grads) -> bool:
        grads = dict(leaves(grads))
        if self.acc is not None:
            n = self.mini_step
            for key, g in grads.items():
                acc = self.acc[key]
                acc.add_((g.float() - acc) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            self.mini_step = 0
            grads = {k: t.clone() for k, t in self.acc.items()}
            for t in self.acc.values():
                t.zero_()
        norm = self.norm(grads) if self.grad_clip is not None else None
        lr = float(self.schedule(self.count))
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for key, p in leaves(params):
            g = grads[key]
            if norm is not None:  # clip_by_global_norm, in g's dtype
                g = torch.where(norm < self.grad_clip, g,
                                (g / norm.to(g.dtype)) * self.grad_clip)
            g = g.float()
            mu, nu = self.mu[key], self.nu[key]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p.float()
            upd = -lr * upd
            if p.dtype == torch.float32:
                p.add_(upd)
            else:
                p.copy_(p.float() + upd)
        return True

    # -- state for checkpoints (the port's own keys) ---------------------
    def state_dict(self) -> Dict[str, torch.Tensor]:
        out = {"count": torch.tensor(self.count),
               "mini_step": torch.tensor(self.mini_step)}
        for part in ("mu", "nu", "acc"):
            state = getattr(self, part)
            if state is not None:
                out.update({f"{part}/{k}": t for k, t in state.items()})
        return out

    def load_state_dict(self, flat: Dict[str, object]) -> None:
        """Restore the keys :meth:`state_dict` writes; an absent key (e.g. a
        JAX-package ``opt.npz``) leaves that part fresh."""
        for part in ("mu", "nu", "acc"):
            state = getattr(self, part)
            if state is None:
                continue
            for key, t in state.items():
                if f"{part}/{key}" in flat:
                    t.copy_(torch.as_tensor(flat[f"{part}/{key}"]))
        self.count = int(flat.get("count", self.count))
        self.mini_step = int(flat.get("mini_step", self.mini_step))
