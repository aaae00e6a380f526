"""JSON I/O, host seeding and the per-process work split — the
single-process part of ``ospo_tpu/io.py``.  Multi-GPU result merging comes
with the scale-out slice (ROADMAP.md queue 1, multi-GPU)."""

from __future__ import annotations

import json
import os
import random
from typing import Any, List, Optional

import numpy as np


def process_index() -> int:
    """This process's rank: the port runs one process."""
    return 0


def process_count() -> int:
    return 1


def read_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def save_json(save_root: str, save_name: str, payload: Any) -> str:
    os.makedirs(save_root, exist_ok=True)
    path = os.path.join(save_root, f"{save_name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=4)
    return path


def save_json_sharded(save_root: str, save_name: str,
                      save_file: List[dict]) -> Optional[str]:
    """Write one JSON of the run's records (``ospo_tpu/io.py:111``): with
    one process that is this process's list, written as given."""
    if process_count() != 1:
        raise NotImplementedError(
            "merging result shards across processes is queued in ROADMAP.md "
            "(queue 1, multi-GPU)")
    return save_json(save_root, save_name, save_file)


def merge_element_sets(local_elements) -> list:
    """Union of the element sets of every process, sorted
    (``ospo_tpu/io.py:136``); one process here."""
    return sorted(set(local_elements))


def shard_for_process(items: list, index: int = 0, count: int = 1) -> list:
    """This process's strided share of a work list.  The port runs one
    process, so the whole list unless a caller shards explicitly."""
    return items[index::count]


def set_seed(seed: int) -> None:
    """Seed the host RNGs; device randomness uses explicit generators
    seeded from the same value."""
    random.seed(seed)
    np.random.seed(seed)
