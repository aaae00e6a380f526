"""Pipeline dataset helpers used by step 3 (copy of ``load_base_dataset``
and ``batched`` from ``ospo_tpu/pipeline/datasets.py``)."""

from __future__ import annotations

from typing import List, Optional, Sequence

from ospo_tpu_torch.io import read_json

# gen_dataset.py:14-24 — default perturbation methods per sub_category
DEFAULT_PERTURBED_METHODS = {
    "attribute1_color": ["replace", "replace", "replace"],
    "attribute1_texture": ["replace", "replace", "replace"],
    "attribute1_shape": ["replace", "replace", "replace"],
    "layout2": ["replace", "replace", "replace"],
    "non-spatial": ["replace", "drop", "replace"],
    "complex": ["replace", "swap", "drop"],
    "attribute2": ["replace", "swap", "drop"],
    "layout1": ["replace", "swap", "drop"],
    "layout3": ["replace", "swap", "drop"],
}


def load_base_dataset(fpath: str, s_idx: Optional[int] = None,
                      e_idx: Optional[int] = None) -> List[dict]:
    data = read_json(fpath)
    if data and data[0].get("perturbed_method") is None:
        for sample in data:
            sub = sample["sub_category"]
            if sub not in DEFAULT_PERTURBED_METHODS:
                raise ValueError(f"Unknown sub_category: {sub}")
            sample["perturbed_method"] = list(DEFAULT_PERTURBED_METHODS[sub])
    return data[s_idx:e_idx]


def batched(items: Sequence, batch_size: int):
    for i in range(0, len(items), batch_size):
        yield items[i : i + batch_size]
