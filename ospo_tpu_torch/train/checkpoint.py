"""Checkpoints: the trained tree + optimizer state + run metadata —
counterpart of ``ospo_tpu/train/checkpoint.py``.

Layout (one directory per saved step, ``.../step_000123/``):
  lora.npz   — the trained tree, path-keyed as the JAX package keys it
               (``q_proj/a``; in full mode ``language_model/layers/wq``,
               list items as ``[i]``, empty containers as
               ``__empty_list__`` / ``__empty_dict__``): the LoRA adapters,
               or the trained submodules of a full fine-tune, written in
               the JAX layout (``weights.to_jax_layout``: HWIO convolution
               kernels, bf16 leaves as the 2-byte voids a JAX bf16 array is
               stored as) and read back as a port tree;
  opt.npz    — optimizer state in the port's own keys (``count``,
               ``mini_step``, ``mu/<path>``, ``nu/…``, ``acc/…``); each
               package ignores the other's, so a resumed run keeps its
               weights and restarts the moments;
  meta.json  — ``{step, mode, lora, scaling}``, the JAX package's keys;
               ``mode`` is ``lora`` or ``full``.

So a checkpoint written by either package loads in the other, and
:func:`merge_lora_checkpoint` folds it into a model for generation.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ospo_tpu_torch.models.weights import from_jax_params, to_jax_layout
from ospo_tpu_torch.train import lora as lora_lib


def _leaf_array(v) -> np.ndarray:
    """A leaf as numpy; bf16 as the 2-byte void holding its bits, which is
    how a JAX bf16 array is stored (and read back) in an ``.npz``."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    v = v.detach().contiguous().cpu()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy().view(np.dtype("V2"))
    return v.numpy()


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Path-keyed leaves, in the JAX package's encoding
    (``ospo_tpu/train/checkpoint.py:37-58``)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree and prefix:
            out[prefix + "__empty_dict__"] = np.zeros((), np.int8)
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree and prefix:
            out[prefix + "__empty_list__"] = np.zeros((), np.int8)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]/"))
    elif tree is not None:
        out[prefix[:-1]] = _leaf_array(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict = {}
    for path, value in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if "__empty_list__" in node:
            return []
        if "__empty_dict__" in node:
            return {}
        if node and all(re.fullmatch(r"\[\d+\]", k) for k in node):
            idx = sorted(int(k[1:-1]) for k in node)
            return [listify(node[f"[{i}]"]) for i in idx]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_checkpoint(ckpt_dir: str, step: int, tree: Dict,
                    lora_cfg: lora_lib.LoraConfig,
                    opt_state: Optional[Dict[str, Any]] = None,
                    mode: str = "lora") -> str:
    """Write ``tree`` (the adapters; in ``mode="full"`` the trained
    submodules, port layout, written in the JAX one) and the optimizer
    state."""
    if mode not in ("lora", "full"):
        raise ValueError(f"checkpoint mode must be lora|full, got {mode!r}")
    if mode == "full":
        tree = to_jax_layout(tree)
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "lora.npz"), **_flatten(tree))
    if opt_state is not None:
        np.savez(os.path.join(path, "opt.npz"), **_flatten(opt_state))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, "mode": mode, "lora": lora_cfg.to_dict(),
                   "scaling": lora_cfg.scaling}, f, indent=2)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def resolve_checkpoint_dir(path: str) -> str:
    """A step directory, or a parent directory → its latest step directory.
    Resolve once and pass the result on, so the tree and the mode come
    from one step while a trainer writes new ones."""
    if not os.path.isfile(os.path.join(path, "meta.json")):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        return latest
    return path


def checkpoint_mode(path: str) -> str:
    """``lora`` or ``full`` (``ospo_tpu/train/checkpoint.py:183-192``): a
    step directory or its parent; a missing ``meta.json`` reads as lora."""
    if not os.path.isfile(os.path.join(path, "meta.json")):
        latest = latest_checkpoint(path)
        if latest:
            path = latest
    try:
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f).get("mode", "lora")
    except FileNotFoundError:
        return "lora"


def load_checkpoint(path: str
                    ) -> Tuple[Dict, lora_lib.LoraConfig, int, Optional[Dict]]:
    """→ (tree, lora config, step, flat opt state or None); ``path`` may be
    a step directory or its parent.  The tree is the adapters (numpy
    leaves), or for a ``mode: full`` checkpoint the trained submodules as a
    port tree (torch leaves on the CPU)."""
    path = resolve_checkpoint_dir(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    tree = _unflatten(load_flat(os.path.join(path, "lora.npz")))
    if meta.get("mode", "lora") == "full":
        saved = from_jax_params(tree)
        if set(saved) != set(tree):
            raise ValueError(f"{path}: unknown submodules "
                             f"{sorted(set(tree) - set(saved))}")
        tree = saved
    opt_path = os.path.join(path, "opt.npz")
    opt_flat = load_flat(opt_path) if os.path.isfile(opt_path) else None
    return (tree, lora_lib.LoraConfig.from_dict(meta.get("lora", {})),
            int(meta.get("step", 0)), opt_flat)


@torch.no_grad()
def assign_tree(dst, src, path: str = "") -> None:
    """Copy ``src`` (torch leaves) into the tensors of ``dst`` in place,
    each cast to the destination's dtype; the two must have one structure
    and one shape per leaf."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"checkpoint tree at {path or '/'} has keys "
                             f"{sorted(src) if isinstance(src, dict) else src!r}"
                             f", the model {sorted(dst)}")
        for k in dst:
            assign_tree(dst[k], src[k], f"{path}/{k}")
    elif isinstance(dst, list):
        if not isinstance(src, list) or len(src) != len(dst):
            raise ValueError(f"checkpoint list at {path} does not match the "
                             "model's")
        for i, (d, s) in enumerate(zip(dst, src)):
            assign_tree(d, s, f"{path}[{i}]")
    else:
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint leaf {path} has shape "
                             f"{tuple(src.shape)}, the model {tuple(dst.shape)}")
        dst.copy_(src)


def merge_lora_checkpoint(model, ckpt_path: str):
    """Fold a trained checkpoint into ``model``'s (unquantized) weights, in
    place, for generation: a LoRA checkpoint merges its adapters (peft's
    ``merge_and_unload``), a full one replaces the trained submodules,
    each leaf cast to the model's dtype (``ospo_tpu/train/checkpoint.py:
    195-214``); a part the model was built without is left out."""
    ckpt_path = resolve_checkpoint_dir(ckpt_path)
    tree, lora_cfg, _, _ = load_checkpoint(ckpt_path)
    if checkpoint_mode(ckpt_path) == "full":
        skipped = []
        for name, sub in tree.items():
            # parts the caller dropped (drop_lm_head, drop_vision,
            # drop_understanding) were never built: nothing to replace
            if name not in model.params:
                skipped.append(name)
                continue
            if name == "language_model" and "lm_head" in sub \
                    and "lm_head" not in model.params[name]:
                sub = {k: v for k, v in sub.items() if k != "lm_head"}
                skipped.append("language_model/lm_head")
            assign_tree(model.params[name], sub, name)
        if skipped:
            print(f"# {ckpt_path}: not built here, not merged: {skipped}")
        return model
    lora_lib.merge_into_janus(model.params, tree, lora_cfg.scaling)
    return model
