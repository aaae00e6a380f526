"""Checkpoints: LoRA adapters + optimizer state + run metadata — counterpart
of ``ospo_tpu/train/checkpoint.py``.

Layout (one directory per saved step, ``.../step_000123/``):
  lora.npz   — the adapter tree, path-keyed (``q_proj/a``, ``q_proj/b``, …),
               the JAX package's keys;
  opt.npz    — optimizer state in the port's own keys (``count``,
               ``mini_step``, ``mu/<proj>/<a|b>``, ``nu/…``, ``acc/…``);
               each package ignores the other's, so a resumed run keeps its
               adapters and restarts the moments;
  meta.json  — ``{step, mode, lora, scaling}``, the JAX package's keys.

So adapters trained by either package load in the other, and
:func:`merge_lora_checkpoint` folds them into a model for generation.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ospo_tpu_torch.train import lora as lora_lib


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (v.detach().cpu().numpy()
                                   if isinstance(v, torch.Tensor) else np.asarray(v))
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    root: Dict = {}
    for path, value in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return root


def load_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_checkpoint(ckpt_dir: str, step: int, lora_tree: Dict,
                    lora_cfg: lora_lib.LoraConfig,
                    opt_state: Optional[Dict[str, Any]] = None) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "lora.npz"), **_flatten(lora_tree))
    if opt_state is not None:
        np.savez(os.path.join(path, "opt.npz"), **_flatten(opt_state))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, "mode": "lora", "lora": lora_cfg.to_dict(),
                   "scaling": lora_cfg.scaling}, f, indent=2)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def resolve_checkpoint_dir(path: str) -> str:
    """A step directory, or a parent directory → its latest step directory."""
    if not os.path.isfile(os.path.join(path, "meta.json")):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        return latest
    return path


def load_checkpoint(path: str
                    ) -> Tuple[Dict, lora_lib.LoraConfig, int, Optional[Dict]]:
    """→ (lora tree of numpy arrays, lora config, step, flat opt state or
    None); ``path`` may be a step directory or its parent."""
    path = resolve_checkpoint_dir(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("mode", "lora") != "lora":
        raise NotImplementedError(
            f"{path} is a {meta.get('mode')!r} checkpoint: full fine-tune "
            "(use_peft: False) is queued in ROADMAP.md (training remainder)")
    tree = _unflatten(load_flat(os.path.join(path, "lora.npz")))
    opt_path = os.path.join(path, "opt.npz")
    opt_flat = load_flat(opt_path) if os.path.isfile(opt_path) else None
    return (tree, lora_lib.LoraConfig.from_dict(meta.get("lora", {})),
            int(meta.get("step", 0)), opt_flat)


def merge_lora_checkpoint(model, ckpt_path: str):
    """Fold a trained LoRA checkpoint into ``model``'s (unquantized) trunk,
    in place — peft's ``merge_and_unload`` for round-2 generation."""
    tree, lora_cfg, _, _ = load_checkpoint(ckpt_path)
    lora_lib.merge_into_janus(model.params, tree, lora_cfg.scaling)
    return model
