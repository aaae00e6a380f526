"""Times the tensor-parallel collectives of one step-3 decode step and of
one step-5 training micro-batch at the Janus-Pro-1B width, tp = 2, between
two ranks on one card (gloo), the layout of ``chip_smoke.py`` phases 16
and 18:

- ``all_reduce_model`` of a row-parallel product, [48, 2048] (two a
  layer, 48 a step; summed in fp32), and gloo's all-reduce of the same
  rows in bf16, half the bytes;
- ``all_gather_last`` of the CFG-combined logits, [24, 8192] fp32 a rank
  (one a step);
- ``broadcast_model`` of the 24 sampled ids (one a step);
- gloo's fp32 all-reduce of a CPU tensor of [48, 2048], the transport
  without the card;
- training (phase 18, 4 pairs: 8 rows of 640 tokens, the 4 records' text
  bucket of 64 and 576 image tokens): ``all_reduce_model`` of a bf16
  row-parallel product or input gradient, [8, 640, 2048] (summed in fp32,
  42 MB), and ``all_gather_last`` of the gen-head logits, [8, 640, 8192]
  fp32 a rank joined to [8, 640, 16384] (336 MB).

Each decode collective is the mean of 300 calls after 20 warm-up calls,
each training one of 20 after 3, synchronised, on the host's clock.  Run: ``scripts/run_multihost_torch.sh 2
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
# a training micro-batch of phase 18: 2 x 4 pairs, text bucket + 576
TRAIN_ROWS, TRAIN_TOKENS, TRAIN_ITERS, TRAIN_WARMUP = 8, 640, 20, 3


def timed(fn, iters=ITERS, warmup=WARMUP) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


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
    del part, logits, host, half
    train = torch.randn((TRAIN_ROWS, TRAIN_TOKENS, HIDDEN), generator=g,
                        device=dev).bfloat16()
    ms["train_all_reduce_model"] = timed(
        lambda: mesh_lib.all_reduce_model(train), TRAIN_ITERS, TRAIN_WARMUP)
    del train
    train_logits = torch.randn((TRAIN_ROWS, TRAIN_TOKENS, IMAGE_VOCAB // 2),
                               generator=g, device=dev)
    ms["train_gather_logits_fp32"] = timed(
        lambda: mesh_lib.all_gather_last(train_logits), TRAIN_ITERS,
        TRAIN_WARMUP)
    if mesh.rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(json.dumps({"tp_collectives_ms": ms, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
