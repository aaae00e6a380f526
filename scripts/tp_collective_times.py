"""Times the tensor-parallel collectives of one step-3 decode step at the
Janus-Pro-1B width, tp = 2, between two ranks on one card (gloo), the
layout of ``chip_smoke.py`` phase 16:

- ``all_reduce_model`` of a row-parallel product, [48, 2048] (two a
  layer, 48 a step; summed in fp32), and gloo's all-reduce of the same
  rows in bf16, half the bytes;
- ``all_gather_last`` of the CFG-combined logits, [24, 8192] fp32 a rank
  (one a step);
- ``broadcast_model`` of the 24 sampled ids (one a step);
- gloo's fp32 all-reduce of a CPU tensor of [48, 2048], the transport
  without the card.

Each is the mean of 300 calls after 20 warm-up calls, synchronised, on the
host's clock.  Run: ``scripts/run_multihost_torch.sh 2
scripts.tp_collective_times`` from the repository's root; rank 0 prints
one JSON line with the card's name and power limit.
"""

import json
import subprocess
import time

import torch
import torch.distributed as dist

from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.platform import maybe_init_distributed

ITERS, WARMUP = 300, 20
ROWS, HIDDEN, PAIRS, IMAGE_VOCAB = 48, 2048, 24, 16384


def timed(fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ITERS * 1e3


def main() -> None:
    maybe_init_distributed()
    mesh = mesh_lib.create_mesh(2)
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(mesh.rank)
    part = torch.randn((ROWS, 1, HIDDEN), generator=g, device=dev)
    logits = torch.randn((PAIRS, IMAGE_VOCAB // 2), generator=g, device=dev)
    ids = torch.zeros((PAIRS,), dtype=torch.long, device=dev)
    host = part.cpu()
    half = part.bfloat16()
    ms = {
        "all_reduce_model": timed(
            lambda: mesh_lib.all_reduce_model(part.bfloat16())),
        "all_reduce_bf16": timed(
            lambda: dist.all_reduce(half, group=mesh.model_group)),
        "gather_logits_fp32": timed(lambda: mesh_lib.all_gather_last(logits)),
        "broadcast_ids": timed(lambda: mesh_lib.broadcast_model(ids)),
        "cpu_all_reduce_fp32": timed(
            lambda: dist.all_reduce(host, group=mesh.model_group)),
    }
    ms["step_collectives"] = (48 * ms["all_reduce_model"]
                              + ms["gather_logits_fp32"] + ms["broadcast_ids"])
    if mesh.rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(json.dumps({"tp_collectives_ms": ms, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
