"""Where the time goes in the port's step-3 decode, on one GPU.

    python3 scripts/profile_torch_step3.py [--preset 7b] [--items 24]
        [--quantize int8|int4|int4g]

Builds the step-3 serving model (random weights, int8 by default, or int4
rows or int4 groups; int8 shbd KV cache),
takes the first ``--items`` long prompts of the step-2 fixture as one CFG
group and, after a short warm-up (kernel build, cuBLAS/cuDNN set-up), runs
the engine's public serving call ``generate_images_device`` (sampling, VQ
decode to uint8 pixels on the device) twice, watching it through the
engine's ``step_hook``:

1. timed with CUDA events: prefill, every decode step, the VQ decode, and
   the host's enqueue time per step;
2. under ``torch.profiler`` for a window of decode steps: device time per
   step by kernel class (CUDA kernels only) and the device's busy share.

The result goes to ``chiprun_out/profile_step3.json`` (int8) or
``chiprun_out/profile_step3_<quantize>.json`` and stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ospo_tpu_torch.engine.image_engine import ImageGenEngine  # noqa: E402
from ospo_tpu_torch.io import read_json  # noqa: E402
from ospo_tpu_torch.models import janus  # noqa: E402
from ospo_tpu_torch.ops import build  # noqa: E402
from ospo_tpu_torch.processing import Processor, t2i_prompt  # noqa: E402
from ospo_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402

WINDOW = (300, 316)  # profiled decode steps (mid decode)


def classify(name: str) -> str:
    n = name.lower()
    if "decode_partial" in n or "decode_combine" in n:
        return "decode_attention kernel"
    if "flash_fwd" in n:
        return "flash_fwd kernel"
    if "int4_decode_m" in n or "int4_combine" in n:   # _matmul (fp32), _mma (bf16)
        return "int4 decode-matmul kernel"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90")):
        return "matmul (cuBLAS)"
    if "copy" in n:
        return "copies and dtype conversion"
    if "reduce" in n:
        return "reductions"
    return "other elementwise / indexing"


def run_group(eng, prompts, on_step=None):
    """One ``generate_images_device`` call; returns CUDA events (call start,
    one per step hook, call end), the host times of the same points and
    the wall seconds of the call."""
    n_img = eng.image_token_num
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_img + 2)]
    host = [0.0] * (n_img + 2)

    def hook(step):
        events[step + 1].record()
        host[step + 1] = time.perf_counter()
        if on_step is not None:
            on_step(step)

    eng.step_hook = hook
    torch.cuda.synchronize()
    events[0].record()
    host[0] = time.perf_counter()
    eng.generate_images_device(prompts, seed=0)
    events[-1].record()
    host[-1] = time.perf_counter()
    torch.cuda.synchronize()
    eng.step_hook = None
    return events, host, time.perf_counter() - host[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="7b", choices=["7b", "1b"])
    ap.add_argument("--items", type=int, default=24)
    ap.add_argument("--quantize", default="int8", choices=["int8", "int4", "int4g"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step3: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    build.build_all()

    cfg = {"7b": janus.JANUS_PRO_7B, "1b": janus.JANUS_PRO_1B}[args.preset]
    model = janus.JanusModel.init(cfg, seed=42, quantize=args.quantize,
                               device="cuda")
    torch.cuda.synchronize()
    proc = Processor(ByteTokenizer(cfg.language.vocab_size))
    data = read_json(os.path.join(ROOT, "tests", "fixtures", "examples",
                                  "step2", "long_prompt.json"))[:args.items]
    prompts = [t2i_prompt(proc, s["long_prompt"][0]) for s in data]
    patch = cfg.vq.downsample_factor
    eng = ImageGenEngine(model, proc, image_token_num=cfg.num_gen_tokens,
                         img_size=cfg.gen_image_size, patch_size=patch,
                         kv_quant="int8", batch_cap=args.items)
    n_img = eng.image_token_num

    # warm-up on the real batch and prompts: 4 image tokens, a 2x2 latent
    warm = ImageGenEngine(model, proc, image_token_num=4, img_size=2 * patch,
                          patch_size=patch, kv_quant="int8",
                          batch_cap=args.items)
    run_group(warm, prompts)

    # pass 1: timed
    events, host, loop_s = run_group(eng, prompts)
    # events[s + 1] is the hook of step s: step s's forward has run
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(1, n_img)]
    host_ms = [(host[i + 1] - host[i]) * 1e3 for i in range(1, n_img)]
    mid = slice(WINDOW[0], WINDOW[1])

    # pass 2: profiled window
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    marks = {}

    def on_step(step):
        if step == WINDOW[0]:
            torch.cuda.synchronize()
            prof.__enter__()
            marks["t0"] = time.perf_counter()
        elif step == WINDOW[1]:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            prof.__exit__(None, None, None)

    run_group(eng, prompts, on_step)
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
    n_win = WINDOW[1] - WINDOW[0]
    device_ms = sum(by_class.values()) / n_win
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    result = {
        "card": smi, "preset": args.preset, "quantize": args.quantize,
        "pairs": len(prompts),
        "image_tokens": n_img,
        "serving_loop_s": loop_s,
        "img_tok_per_s_serving_loop": len(prompts) * n_img / loop_s,
        # batch build, cache allocation and the prompt prefill
        "prefill_ms": events[0].elapsed_time(events[1]),
        "decode_step_ms": {"first_50": mean(step_ms[:50]),
                           "window": mean(step_ms[mid]),
                           "last_50": mean(step_ms[-50:]),
                           "all": mean(step_ms)},
        "host_enqueue_ms_per_step": {"first_50": mean(host_ms[:50]),
                                     "window": mean(host_ms[mid]),
                                     "last_50": mean(host_ms[-50:])},
        # the last step's sampling and the VQ decode to uint8 pixels
        "vq_decode_ms": events[n_img].elapsed_time(events[n_img + 1]),
        "profiled_steps": n_win,
        "profiled_wall_ms_per_step": (marks["t1"] - marks["t0"]) * 1e3 / n_win,
        "device_kernel_ms_per_step": device_ms,
        "device_busy_share_unprofiled": device_ms / mean(step_ms[mid]),
        "device_ms_per_step_by_class": {
            k: v / n_win for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {
            k: v / n_win for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:12]},
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = "profile_step3.json" if args.quantize == "int8" else \
        f"profile_step3_{args.quantize}.json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
