"""Where the time goes in the port's step-5 training step, on one GPU.

    python3 scripts/profile_torch_step5.py [--bucket N]

Builds the Janus-Pro-7B step-5 model (random bf16 weights) and ``SimPOTrainer`` from
``configs/step5.yaml`` with ``attn_impl: flash``, and runs full training
steps (VQ encode, 2B trunk forward with LoRA and remat, SimPO loss,
backward, AdamW) on one batch of 16 pairs at the text bucket of the step-4
fixture's prompts, or ``--bucket`` (random 384x384 uint8 images):

1. two warm-up steps (kernel build, cuBLAS/cuDNN set-up);
2. three steps timed with CUDA events;
3. one step under ``torch.profiler``: device time by kernel class (CUDA
   kernels only), the three flash kernels' share, and the device's busy
   share of the unprofiled step.

The result goes to ``chiprun_out/profile_step5_t<bucket>.json`` and stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ospo_tpu_torch.config import Config, load_yaml  # noqa: E402
from ospo_tpu_torch.io import read_json  # noqa: E402
from ospo_tpu_torch.models import janus  # noqa: E402
from ospo_tpu_torch.ops import build  # noqa: E402
from ospo_tpu_torch.processing import Processor, t2i_prompt  # noqa: E402
from ospo_tpu_torch.tokenizer import load_tokenizer  # noqa: E402
from ospo_tpu_torch.train.trainer import SimPOTrainer, _bucket  # noqa: E402

STEPS = 3  # timed steps
CLASSES = (("flash_fwd", "flash_fwd kernel"),
           ("flash_bwd_dq", "flash_bwd_dq kernel"),
           ("flash_bwd_dkv", "flash_bwd_dkv kernel"))


def classify(name: str) -> str:
    n = name.lower()
    for key, label in CLASSES:
        if key in n:
            return label
    if any(s in n for s in ("conv", "fprop", "implicit", "winograd", "cudnn")):
        return "convolution (cuDNN, VQ encoder)"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90")):
        return "matmul (cuBLAS)"
    if "copy" in n:
        return "copies and dtype conversion"
    if "reduce" in n or "softmax" in n:
        return "reductions and softmax"
    return "other elementwise / indexing"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bucket", type=int, default=None,
                    help="text bucket (default: the fixture prompts' bucket)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step5: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    build.build_all()

    cfg = janus.JANUS_PRO_7B
    model = janus.JanusModel.init(cfg, seed=42, device="cuda")
    config = load_yaml(os.path.join(ROOT, "configs", "step5.yaml"))
    config["experiment"]["attn_impl"] = "flash"
    config["base"]["save_path"] = os.path.join(ROOT, "chiprun_out", "step5")
    tok = load_tokenizer(None, vocab_size=cfg.language.vocab_size)
    proc = Processor(tok)
    trainer = SimPOTrainer(Config.from_nested(config), model, proc)

    prompts = [r["prompt"] for r in read_json(os.path.join(
        ROOT, "tests", "fixtures", "examples", "step4", "train.json"))]
    texts = [tok.encode(t2i_prompt(proc, p)) for p in prompts]
    pairs = int(config["dataset"]["train"]["batch_size"])
    bucket = args.bucket or _bucket(max(len(t) for t in texts))
    texts = [t[:bucket] for t in texts]
    rng = np.random.default_rng(0)
    text_ids = np.zeros((pairs, bucket), np.int32)
    text_mask = np.zeros((pairs, bucket), np.float32)
    for i in range(pairs):
        ids = texts[i % len(texts)]
        text_ids[i, :len(ids)] = ids
        text_mask[i, :len(ids)] = 1.0
    size = cfg.image_size
    pixels = [rng.integers(0, 256, (pairs, size, size, 3)).astype(np.uint8)
              for _ in range(2)]
    batch = (text_ids, text_mask, *pixels)

    def step(i):
        trainer._step(*batch, dropout_seed=i)

    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS + 1)]
    events[0].record()
    for i in range(STEPS):
        step(10 + i)
        events[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(STEPS)]

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof:
        step(99)
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        if ms <= 0:
            continue
        by_name[e.key[:90]] = by_name.get(e.key[:90], 0.0) + ms
        c = classify(e.key)
        by_class[c] = by_class.get(c, 0.0) + ms
    device_ms = sum(by_class.values())
    flash_ms = sum(by_class.get(label, 0.0) for _, label in CLASSES)
    mean_step = sum(step_ms) / len(step_ms)
    result = {
        "card": smi, "preset": "7b", "pairs": pairs,
        "text_bucket": bucket, "sequence": bucket + cfg.num_gen_tokens,
        "step_ms": step_ms,
        "samples_per_s": pairs / (mean_step / 1e3),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profiled_wall_ms": profiled_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share_unprofiled": device_ms / mean_step,
        "flash_kernels_ms": flash_ms,
        "flash_share_of_step": flash_ms / mean_step,
        "device_ms_by_class": dict(sorted(by_class.items(),
                                          key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:12]),
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"profile_step5_t{bucket}.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
