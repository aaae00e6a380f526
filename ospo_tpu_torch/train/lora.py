"""LoRA adapters for the Llama trunk, stacked per layer — counterpart of
``ospo_tpu/train/lora.py``.

The adapter tree is ``{proj: {"a": [L, d_in, r], "b": [L, r, d_out]}}`` in
fp32, the JAX package's layout (``llama.forward``'s ``lora`` argument slices
it per layer).  peft defaults: A ~ kaiming-uniform with bound 1/√d_in,
B = 0, scaling = α/r.  :func:`merge` folds ``scaling·A@B`` into the base
weights (peft's ``merge_and_unload``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ospo_tpu_torch.models.llama import LlamaConfig

PROJ_TO_PARAM = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}

DEFAULT_TARGETS = tuple(PROJ_TO_PARAM)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 32
    alpha: int = 64
    dropout: float = 0.05
    target_modules: Tuple[str, ...] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def to_dict(self) -> dict:
        return {
            "lora_rank": self.rank,
            "lora_alpha": self.alpha,
            "lora_dropout": self.dropout,
            "target_modules": list(self.target_modules),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LoraConfig":
        return cls(
            rank=int(d.get("lora_rank", 32)),
            alpha=int(d.get("lora_alpha", 64)),
            dropout=float(d.get("lora_dropout", 0.05)),
            target_modules=tuple(d.get("target_modules", DEFAULT_TARGETS)),
        )


def proj_widths(cfg: LlamaConfig) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) of each adaptable projection."""
    d, inter = cfg.hidden_size, cfg.intermediate_size
    qd, kvd = cfg.num_heads * cfg.dim_head, cfg.kv_heads * cfg.dim_head
    return {"q_proj": (d, qd), "k_proj": (d, kvd), "v_proj": (d, kvd),
            "o_proj": (qd, d), "gate_proj": (d, inter), "up_proj": (d, inter),
            "down_proj": (inter, d)}


def init_lora(cfg: LlamaConfig, lora_cfg: LoraConfig, seed: int,
              device=None) -> Dict:
    """Zero-effect init: A uniform in ±1/√d_in (peft's kaiming_uniform_ with
    a=√5), B zeros, fp32, drawn from a generator seeded with ``seed`` (values
    differ from the JAX package's)."""
    device = torch.device(device or "cpu")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    widths = proj_widths(cfg)
    n, r = cfg.num_layers, lora_cfg.rank
    tree: Dict = {}
    for name in lora_cfg.target_modules:
        d_in, d_out = widths[name]
        bound = (1.0 / d_in) ** 0.5
        a = torch.empty((n, d_in, r), dtype=torch.float32, device=device)
        a.uniform_(-bound, bound, generator=gen)
        tree[name] = {"a": a, "b": torch.zeros((n, r, d_out),
                                                dtype=torch.float32,
                                                device=device)}
    return tree


@torch.no_grad()
def merge(base_llama_params: Dict, lora_tree: Dict, scaling: float) -> Dict:
    """Fold adapters into the stacked base weights (merge_and_unload).

    Updates the ``[L, d_out, d_in]`` projection stacks IN PLACE, one layer
    at a time (fp32 sum, rounded back to the weight's dtype), so no second
    trunk and only one layer's fp32 temporary is ever alive; returns the
    same tree."""
    layers = base_llama_params["layers"]
    for name, ab in lora_tree.items():
        w = layers[PROJ_TO_PARAM[name]]
        if isinstance(w, dict):
            raise ValueError(f"merge: {PROJ_TO_PARAM[name]} is quantized; "
                             "merge adapters before quantizing the trunk")
        a = torch.as_tensor(ab["a"], dtype=torch.float32, device=w.device)
        b = torch.as_tensor(ab["b"], dtype=torch.float32, device=w.device)
        for li in range(w.shape[0]):
            delta = (a[li] @ b[li]).T * scaling
            w[li] = (w[li].float() + delta).to(w.dtype)
    return base_llama_params


def merge_into_janus(janus_params: Dict, lora_tree: Dict, scaling: float) -> Dict:
    merge(janus_params["language_model"], lora_tree, scaling)
    return janus_params
