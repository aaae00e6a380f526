"""Where the time goes in the port's step 4b (self-VQA scoring), on one GPU.

    python3 scripts/profile_torch_score.py [--questions 3] [--rows 8]

Builds step 4b's model (random int8 weights at the Janus-Pro-7B width,
SigLIP-L and the aligner, ``lm_head``), then prepares one shared-program
slice the way ``chip_smoke.py`` phase 9 runs them (``--rows`` images of
384 × 384, each with ``--questions`` of the step-4 fixture's questions, the
byte tokenizer, the int8 prefix cache) and runs it through the engine's
``_execute_shared_slice``:

1. twice more after a warm-up, timed with CUDA events around each part of
   the slice (the ViT and aligner, the B = 1 pre-image prefill, the image
   prefill, the question suffixes) and with the host's clock around the
   whole slice;
2. once under ``torch.profiler``: kernel time by part and, inside each
   part, by class — the W8A16 products (their int8 → bf16 weight copies
   apart from the cuBLAS products), the plain attention forms (the ViT's,
   the prefix form of the image prefill, ``xla_attention``'s cache read
   for the suffixes), the flash kernel, ``lm_head`` — the largest kernels by name,
   and the device's busy share (kernel time over the unprofiled slice).

Also timed on the host: ``prepare_shared_multi`` for a chunk of 16 images
(the step's host half, which ``run_scoring`` overlaps with the device).
The parts are ``record_function`` ranges wrapped around those functions
here (the package itself is not changed).  Result:
``chiprun_out/profile_score.json`` and stdout.
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

from ospo_tpu_torch.engine.scoring import ScoringEngine  # noqa: E402
from ospo_tpu_torch.image_processing import ImageProcessor  # noqa: E402
from ospo_tpu_torch.io import read_json  # noqa: E402
from ospo_tpu_torch.models import janus, llama, vit  # noqa: E402
from ospo_tpu_torch.ops import attention, build  # noqa: E402
from ospo_tpu_torch.processing import Processor  # noqa: E402
from ospo_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402

VQA = os.path.join(ROOT, "tests", "fixtures", "examples", "step4",
                   "vqa_prompt.json")
# the slice's parts: ScoringEngine methods wrapped in record_function ranges
OUTER = {"_encode_images": "vit", "_prefill_pre": "pre_image_prefill",
         "_prefill_images": "image_prefill", "_suffix_probs": "suffixes"}
# functions inside them, wrapped the same way: (range name, module, attribute)
INNER = (("w8a16", llama, "quantized_matmul"),
         ("vit_attention", vit, "attention"),
         ("prefix_attention", attention, "_prefix_chunk_attention"),
         ("suffix_attention", llama, "xla_attention"),
         ("lm_head", janus, "lm_logits"))


def kernel_class(name: str) -> str:
    n = name.lower()
    if "flash" in n:
        return "flash_kernel"
    if "copy" in n:
        return "copies"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90")):
        return "cublas"
    return "other"


def wrap(owner, attr, name):
    fn = getattr(owner, attr)

    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)

    setattr(owner, attr, wrapped)


def slice_inputs(engine, rows, n_questions):
    """One slice's operands: ``rows`` random 384-px images, each with the
    first fixture record that has ``n_questions`` questions."""
    qs = next(r["question"] for r in read_json(VQA)
              if len(r["question"]) == n_questions)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (384, 384, 3)).astype(np.uint8)
              for _ in range(16)]
    t0 = time.perf_counter()
    prep16 = engine.prepare_shared_multi(images, [qs] * 16)
    prep_s = time.perf_counter() - t0
    ops = [o[:rows] for o in prep16.operands[:5]] + \
        [o[:, :rows] for o in prep16.operands[5:]]
    return ops, prep16.pre, [len(qs)] * rows, prep_s


def timed_slice(engine, ops, pre, q_counts):
    """CUDA events around each part, the host's clock around the slice."""
    events = {}
    saved = {m: getattr(ScoringEngine, m) for m in OUTER}

    def timed(name, fn):
        def call(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            events[name] = ev
            return out
        return call

    for m, name in OUTER.items():
        setattr(ScoringEngine, m, timed(name, saved[m]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = torch.cuda.Event(enable_timing=True)
        last = torch.cuda.Event(enable_timing=True)
        first.record()
        engine._execute_shared_slice(ops, pre, q_counts)
        last.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for m, fn in saved.items():
            setattr(ScoringEngine, m, fn)
    parts = {k: a.elapsed_time(b) for k, (a, b) in events.items()}
    return {"parts_ms": parts, "slice_ms_device": first.elapsed_time(last),
            "slice_ms_host": host_ms}


def profiled_slice(engine, ops, pre, q_counts):
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    with prof:
        engine._execute_shared_slice(ops, pre, q_counts)
        torch.cuda.synchronize()
    inner_names = {name for name, _, _ in INNER}
    range_names = inner_names | set(OUTER.values())
    # each kernel goes to the innermost range whose span on the device
    # (the range's own annotation event) holds its start
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in dev
             if e.name in range_names]
    table = {}
    for k in dev:
        if k.name in range_names:
            continue
        t = k.time_range.start
        held = [n for a, b, n in spans if a <= t < b]
        outer = next((n for n in held if n in OUTER.values()), "outside")
        inner = next((n for n in held if n in inner_names), None)
        cls = kernel_class(k.name)
        key = f"w8a16_{cls}" if inner == "w8a16" else (inner or cls)
        part = table.setdefault(outer, {})
        part[key] = part.get(key, 0.0) + k.time_range.elapsed_us() / 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.key not in range_names:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return {
        "kernel_ms_by_part": {p: {k: round(v, 3) for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])} for p, d in table.items()},
        "kernel_ms_total": sum(by_name.values()),
        "range_spans_on_device": len(spans),
        "top_kernels_ms": {k[:90]: v for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:15]},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--questions", type=int, default=3)
    ap.add_argument("--rows", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_score: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    build.build_all(["flash_fwd"])
    cfg = janus.JANUS_PRO_7B
    model = janus.JanusModel.init(cfg, seed=42, quantize="int8", device="cuda")
    proc = Processor(ByteTokenizer(cfg.language.vocab_size),
                     ImageProcessor(image_size=cfg.image_size),
                     num_image_tokens=cfg.num_image_tokens)
    engine = ScoringEngine(model, proc, kv_quant="int8")
    ops, pre, q_counts, prep_s = slice_inputs(engine, args.rows,
                                              args.questions)
    engine._execute_shared_slice(ops, pre, q_counts)      # warm-up
    runs = [timed_slice(engine, ops, pre, q_counts) for _ in range(2)]
    for m, name in OUTER.items():
        wrap(ScoringEngine, m, name)
    for name, owner, attr in INNER:
        wrap(owner, attr, name)
    torch.cuda.reset_peak_memory_stats()
    prof = profiled_slice(engine, ops, pre, q_counts)
    unprofiled = sum(r["slice_ms_device"] for r in runs) / len(runs)
    result = {
        "card": smi, "rows": args.rows, "questions": args.questions,
        "buckets": {"p_b": int(ops[0].shape[1]), "t_b": int(ops[5].shape[2]),
                    "pre": None if pre is None else int(pre[0].shape[1])},
        "prepare_shared_multi_16_images_s": prep_s,
        "timed_runs": runs,
        "device_busy_share_unprofiled": prof["kernel_ms_total"] / unprofiled,
        "peak_memory_gb_profiled_slice": torch.cuda.max_memory_allocated() / 1e9,
        **prof,
    }
    print(json.dumps(result, indent=1), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_score.json"), "w") as f:
        json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
