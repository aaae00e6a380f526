"""Pipeline dataset helpers used by steps 2 to 5 (copy of
``load_base_dataset``, ``batched``, ``batched_grouped`` and
``PreferenceDataset`` from ``ospo_tpu/pipeline/datasets.py``; PNGs are
decoded by ``utils/png``)."""

from __future__ import annotations

import itertools
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ospo_tpu_torch.io import read_json
from ospo_tpu_torch.processing import Processor, t2i_prompt
from ospo_tpu_torch.utils.png import read_png

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


def batched_grouped(items: Sequence, batch_size: int, key):
    """Batches within runs of equal ``key`` (``items`` sorted by it), so
    every batch shares one few-shot template and the text engine's
    shared-prefix program stores that template once per batch; each
    group's last batch may be short."""
    for _, grp in itertools.groupby(items, key=key):
        yield from batched(list(grp), batch_size)


class PreferenceDataset:
    """train.json records → (item_id, text token ids, chosen/rejected uint8
    pixels) — ``PreferenceDataset`` (``ospo_tpu/pipeline/datasets.py:76-165``).
    Image → VQ-token encoding happens on the device in the train step."""

    def __init__(self, seed: int, data_path: str, processor: Processor,
                 num_samples: Optional[int] = None):
        self.processor = processor
        self.dataset = read_json(data_path)
        if num_samples is not None:
            if not 0 < num_samples <= len(self.dataset):
                raise ValueError(f"num_samples {num_samples} outside 1.."
                                 f"{len(self.dataset)} ({data_path})")
            rng = random.Random(seed)
            idx = rng.sample(range(len(self.dataset)), num_samples)
            self.dataset = [self.dataset[i] for i in idx]
        self.data_root: Optional[str] = None  # override for relocated images

    def __len__(self) -> int:
        return len(self.dataset)

    def resolve_path(self, path: str) -> str:
        """train.json may carry absolute paths from another machine: re-root
        at ``self.data_root`` from the LAST base|negative component (the
        step-3 layout anchor)."""
        if os.path.exists(path) or self.data_root is None:
            return path
        parts = path.replace("\\", "/").split("/")
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] in ("base", "negative"):
                return os.path.join(self.data_root, *parts[i:])
        return path

    def get_text_tokens(self, prompt: str) -> np.ndarray:
        full = t2i_prompt(self.processor, prompt)
        return np.asarray(self.processor.tokenizer.encode(full), np.int32)

    def get_image(self, path: str) -> np.ndarray:
        """uint8 [H, W, 3]; rescale and normalize run on the device."""
        return self.processor.image_processor.process_one_u8(
            read_png(self.resolve_path(path)))

    def __getitem__(self, idx: int) -> Dict:
        ex = self.dataset[idx]
        for key in ("prompt", "chosen", "rejected"):
            if key not in ex:
                raise ValueError(
                    f"Could not format example for SimPO: missing '{key}' "
                    f"(has {list(ex.keys())})")
        return {
            "item_id": ex["item_id"],
            "text_tokens": self.get_text_tokens(ex["prompt"]),
            "chosen_pixels": self.get_image(ex["chosen"]),
            "rejected_pixels": self.get_image(ex["rejected"]),
        }

    def max_text_len(self) -> int:
        """Longest tokenized prompt (a host pass, no image IO): the trainer
        pads every batch to one run-level text bucket."""
        return max(len(self.get_text_tokens(ex["prompt"]))
                   for ex in self.dataset)

    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     seed: int = 0, part: Tuple[int, int] = (0, 1)):
        """Global batches of ``batch_size`` records in a seeded order; with
        ``part = (rank, n)`` only the rank's contiguous rows
        ``[rank·b/n, (rank+1)·b/n)`` of each, loaded (a data-parallel
        process).  A batch that ``n`` does not divide is a ValueError."""
        rank, n = part
        order = list(range(len(self.dataset)))
        if shuffle:
            random.Random(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            rows = order[i : i + batch_size]
            if len(rows) % n:
                raise ValueError(
                    f"a global batch of {len(rows)} records does not split "
                    f"over {n} processes")
            k = len(rows) // n
            yield [self[j] for j in rows[rank * k : (rank + 1) * k]]
