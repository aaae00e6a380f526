"""JSON I/O, host seeding and the per-process work split — the
single-process part of ``ospo_tpu/io.py``.  Multi-GPU result merging comes
with the scale-out slice."""

from __future__ import annotations

import json
import os
import random
from typing import Any

import numpy as np


def read_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def save_json(save_root: str, save_name: str, payload: Any) -> str:
    os.makedirs(save_root, exist_ok=True)
    path = os.path.join(save_root, f"{save_name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=4)
    return path


def shard_for_process(items: list, index: int = 0, count: int = 1) -> list:
    """This process's strided share of a work list.  The port runs one
    process, so the whole list unless a caller shards explicitly."""
    return items[index::count]


def set_seed(seed: int) -> None:
    """Seed the host RNGs; device randomness uses explicit generators
    seeded from the same value."""
    random.seed(seed)
    np.random.seed(seed)
