"""JSON I/O, host seeding, the per-process work split and the merge of
result shards across processes — the port of ``ospo_tpu/io.py``.

The reference merges per-rank result lists with ``all_gather_object`` and
a rank-0 dedup by ``item_id`` (``ospo/utils/common.py:36-58``); here the
gather is ``torch.distributed.all_gather_object`` on a gloo group, so host
objects never need a CUDA collective.  Without a process group every
function is its one-process form.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, List, Optional

import numpy as np


def _world() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the process group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if _world() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _world() else 1


def data_index() -> int:
    """This process's share of the work: its rank, or under tensor parallel
    its model group's index (``parallel/mesh.py``: the ranks of a group
    serve the same items)."""
    from ospo_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    return mesh.data_index if mesh is not None else process_index()


def data_count() -> int:
    """The number of shares: the world size, or the number of model
    groups under tensor parallel."""
    from ospo_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    return mesh.data if mesh is not None else process_count()


def read_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def save_json(save_root: str, save_name: str, payload: Any) -> str:
    os.makedirs(save_root, exist_ok=True)
    path = os.path.join(save_root, f"{save_name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=4)
    return path


def dedup_by_item_id(records: List[dict]) -> List[dict]:
    """Drop the records whose ``item_id`` came earlier and sort by the id as
    a number — the reference's rank-0 merge (``ospo_tpu/io.py:54``)."""
    seen = set()
    out = []
    for sample in records:
        if sample["item_id"] in seen:
            continue
        seen.add(sample["item_id"])
        out.append(sample)
    return sorted(out, key=lambda x: int(x["item_id"]))


def gather_objects(local: Any) -> List[Any]:
    """Every process's ``local`` (picklable), in rank order
    (``ospo_tpu/io.py:80``); ``[local]`` without a process group."""
    if process_count() == 1:
        return [local]
    import torch.distributed as dist

    from ospo_tpu_torch.platform import object_group

    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, local, group=object_group())
    return out


def save_json_sharded(save_root: str, save_name: str,
                      save_file: List[dict]) -> Optional[str]:
    """Merge every process's records and write one JSON from rank 0
    (``ospo_tpu/io.py:111``, the reference's ``save_json_ddp``): rank 0
    concatenates the shards in rank order, dedups by ``item_id`` and sorts,
    writes and returns the path; the other ranks return None.  Under tensor
    parallel only model rank 0 of each group contributes (its peers hold
    the same records).  One process writes its list as given."""
    if process_count() == 1:
        return save_json(save_root, save_name, save_file)
    from ospo_tpu_torch.parallel.mesh import model_rank

    gathered = gather_objects(save_file if model_rank() == 0 else [])
    if process_index() != 0:
        return None
    return save_json(save_root, save_name, dedup_by_item_id(
        [rec for shard in gathered for rec in shard]))


def merge_element_sets(local_elements) -> list:
    """Union of every process's element set, sorted (``ospo_tpu/io.py:136``)."""
    merged = set()
    for shard in gather_objects(sorted(local_elements)):
        merged.update(shard)
    return sorted(merged)


def shard_for_process(items: list, index: Optional[int] = None,
                      count: Optional[int] = None) -> list:
    """This process's strided share of a work list (``ospo_tpu/io.py:152``):
    ``index`` and ``count`` default to :func:`data_index` and
    :func:`data_count` (this rank and the world size without tensor
    parallel)."""
    index = data_index() if index is None else index
    count = data_count() if count is None else count
    return items[index::count]


def set_seed(seed: int) -> None:
    """Seed the host RNGs; device randomness uses explicit generators
    seeded from the same value."""
    random.seed(seed)
    np.random.seed(seed)
