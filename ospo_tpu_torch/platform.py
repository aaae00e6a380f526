"""Device resolution and the multi-process runtime for the port's entry
points: the GPU unless the caller asks for the CPU, never a quiet fallback,
and one process per card in a data-parallel world."""

from __future__ import annotations

import atexit
import datetime
import os
import sys
from typing import Optional, Union

import torch

# this process's device in a world that maybe_init_distributed joined
_WORLD_DEVICE: Optional[torch.device] = None
_OBJECT_GROUP = None    # a gloo group for host objects beside an NCCL one


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``: in a world :func:`maybe_init_distributed`
    joined, this process's card for ``None`` and ``"cuda"``.  Raises when
    CUDA is asked for and absent."""
    if device in (None, "cuda") and _WORLD_DEVICE is not None \
            and _WORLD_DEVICE.type == "cuda":
        return _WORLD_DEVICE
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu' (config key `device: cpu`)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def maybe_init_distributed(device: Optional[Union[str, torch.device]] = None
                           ) -> None:
    """Join the multi-process runtime when launched by
    ``scripts/run_multihost_torch.sh`` (or anything that exports
    ``OSPO_COORDINATOR`` = host:port, ``OSPO_NUM_PROCESSES``,
    ``OSPO_PROCESS_ID`` and optionally ``OSPO_LOCAL_DEVICE_IDS``): the port of
    ``ospo_tpu/platform.py:59-86``.  A no-op when they are unset or a group
    exists.  ``device`` is the run's config key (``cpu`` or the GPU).

    Each rank's card is ``cuda:<OSPO_LOCAL_DEVICE_IDS[0]>``, else
    ``cuda:<rank mod device_count>``.  The backend follows from the
    placement, found before the group exists by comparing the ranks' device
    UUIDs through the coordinator's TCP store: ``gloo`` for ``device: cpu``,
    ``nccl`` when every rank has a card of its own, ``gloo`` when ranks
    share a card (NCCL refuses two ranks on one device; gloo's
    ``all_reduce`` takes CUDA tensors).  Host objects always travel on a
    gloo group (:func:`object_group`)."""
    global _WORLD_DEVICE
    import torch.distributed as dist

    coord = os.environ.get("OSPO_COORDINATOR")
    if not coord or dist.is_initialized():
        return
    world = int(os.environ["OSPO_NUM_PROCESSES"])
    rank = int(os.environ["OSPO_PROCESS_ID"])
    host, port = coord.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=datetime.timedelta(minutes=10))
    if torch.device(device or "cuda").type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        ids = os.environ.get("OSPO_LOCAL_DEVICE_IDS")
        dev = resolve_device(f"cuda:{int(ids.split(',')[0])}" if ids else
                             f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
        store.set(f"ospo_device_uuid/{rank}",
                  str(torch.cuda.get_device_properties(dev).uuid))
        uuids = {store.get(f"ospo_device_uuid/{r}") for r in range(world)}
        backend = "nccl" if len(uuids) == world else "gloo"
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    # leave the group before the interpreter tears down: a group (and the
    # store rank 0 serves) destroyed at teardown can abort the process
    atexit.register(_leave)
    _WORLD_DEVICE = dev
    # one write a line: the ranks share the launcher's output
    sys.stdout.write(f"# distributed runtime: process {rank}/{world} @ "
                     f"{coord} backend {backend} device {dev}\n")
    sys.stdout.flush()


def _leave() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def object_group():
    """The group host objects travel on (``io.gather_objects``, the
    trainer's barrier): the default group when it is gloo (``None``), else
    a gloo group made on the first call, which every rank makes together,
    so host objects never need a CUDA collective."""
    global _OBJECT_GROUP
    import torch.distributed as dist

    if _OBJECT_GROUP is None and dist.get_backend() != "gloo":
        _OBJECT_GROUP = dist.new_group(backend="gloo")
    return _OBJECT_GROUP
