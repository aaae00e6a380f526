"""Where the time goes in the port's text decode (steps 1, 2 and 4a), on one
GPU.

    python3 scripts/profile_torch_text.py [--new-tokens 128]

Builds the text steps' serving model (random int8 weights at the 7B width,
``drop_vision``, ``lm_head``), then for each case below runs the engine's
public call ``generate_ids`` twice after a short warm-up, watching it
through the engine's ``step_hook``:

- ``step1``: 64 samples of the step-1 prompt (category object), shared
  prefix; ``step1_plain``: the same on the plain program (the decode
  kernel); ``step2``: step 2a's first perturbation of the fixture's 10
  complex base prompts; ``step4a``: step 4a's prompts of the fixture's 10
  complex long-prompt items.  Sampling settings from each step's config.

1. timed with CUDA events: every decode step (device timeline) and the
   host's time between steps;
2. under ``torch.profiler`` for 16 mid-decode steps: kernel time per step
   by part — the W8A16 products (their int8 → bf16 weight copies apart),
   the plain prefix read (``ops/attention.prefix_decode_attention``), the
   decode kernel, ``lm_head`` and sampling — the largest kernels by name,
   and the device's busy share (kernel time over the unprofiled step).

The parts are the kernels launched inside ``record_function`` ranges that
wrap those functions here (the package itself is not changed); the decode
kernel, launched through ``ctypes``, is found by its kernel names.
Result: ``chiprun_out/profile_text.json`` and stdout.
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

from ospo_tpu_torch import chat  # noqa: E402
from ospo_tpu_torch.engine.text_engine import TextGenEngine, _bucket_tail  # noqa: E402
from ospo_tpu_torch.io import read_json  # noqa: E402
from ospo_tpu_torch.models import janus, llama  # noqa: E402
from ospo_tpu_torch.ops import build, sampling  # noqa: E402
from ospo_tpu_torch.pipeline.step2 import build_negative_prompts  # noqa: E402
from ospo_tpu_torch.pipeline.step4 import build_question_prompts  # noqa: E402
from ospo_tpu_torch.pipeline.templates import get_element_conversation  # noqa: E402
from ospo_tpu_torch.processing import Processor  # noqa: E402
from ospo_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402

EXAMPLES = os.path.join(ROOT, "tests", "fixtures", "examples")
WINDOW = 16  # profiled decode steps, centred on the middle of the call
# (range name, module, attribute) wrapped in record_function ranges
PARTS = (("w8a16", llama, "quantized_matmul"),
         ("prefix_read", llama, "prefix_decode_attention"),
         ("decode_kernel", llama, "decode_attention"),
         ("lm_head", janus, "lm_logits"),
         ("sampling", sys.modules[TextGenEngine.__module__], "sample_token"))


def cases():
    """name → (prompts, generation settings, shared_prefix)."""
    system, conv = get_element_conversation("object")
    p1 = chat.apply_sft_template(conv, system_prompt=system)
    group = [r for r in read_json(os.path.join(EXAMPLES, "step1", "base_prompt.json"))
             if r["sub_category"] == "complex"]
    for r in group:
        r["perturbed_method"] = ["replace", "swap", "drop"]
    p2 = [p for p in build_negative_prompts(group, 0, 0)[0] if p]
    items = [r for r in read_json(os.path.join(EXAMPLES, "step2", "long_prompt.json"))
             if r["category"] == "complex"]
    p4 = build_question_prompts(items)
    g1 = {"temperature": 1.3}
    return {"step1": ([p1] * 64, g1, True),
            "step1_plain": ([p1] * 64, g1, False),
            "step2": (p2, {"temperature": 1.2, "top_p": 0.5}, True),
            "step4a": (p4, {"temperature": 0.8, "top_p": 0.9}, True)}


def kernel_class(name: str) -> str:
    n = name.lower()
    if "decode_partial" in n or "decode_combine" in n:
        return "decode_kernel"
    if "copy" in n:
        return "copies"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90")):
        return "cublas"
    return "other"


def _kernels(evt):
    yield from evt.kernels
    for child in evt.cpu_children:
        yield from _kernels(child)


def run(eng, prompts, on_step=None):
    """One ``generate_ids`` call → (CUDA events and host times at each step
    hook, wall seconds)."""
    events, host = [], []

    def hook(step):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        host.append(time.perf_counter())
        if on_step is not None:
            on_step(step)

    eng.step_hook = hook
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate_ids(prompts, seed=0)
    wall = time.perf_counter() - t0
    eng.step_hook = None
    return events, host, wall


def profile_case(model, proc, prompts, gen, shared, new_tokens):
    mk = lambda n: TextGenEngine(model, proc, max_new_tokens=n,  # noqa: E731
                                 kv_quant="int8", batch_cap=64,
                                 shared_prefix=shared, **gen)
    run(mk(4), prompts)                                   # warm-up
    eng = mk(new_tokens)
    split = eng._shared_split(prompts)
    events, host, wall = run(eng, prompts)
    n = len(events)
    lo, hi = n // 2 - WINDOW // 2, n // 2 + WINDOW // 2
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(1, n - 1)]
    host_ms = [(host[i + 1] - host[i]) * 1e3 for i in range(1, n - 1)]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    marks = {}

    def on_step(step):
        if step == lo:
            torch.cuda.synchronize()
            prof.__enter__()
            marks["t0"] = time.perf_counter()
        elif step == hi:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            prof.__exit__(None, None, None)

    run(eng, prompts, on_step)
    parts = {name: 0.0 for name, _, _ in PARTS}
    # kernels by name; the ranges' own GPU-side spans are left out
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in parts:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3
    total = sum(by_name.values())
    w8a16 = {"copies": 0.0, "cublas": 0.0, "other": 0.0, "decode_kernel": 0.0}
    for evt in prof.events():
        if evt.name in parts and evt.device_type == torch.autograd.DeviceType.CPU:
            ks = list(_kernels(evt))
            parts[evt.name] += sum(k.duration for k in ks) / 1e3
            if evt.name == "w8a16":
                for k in ks:
                    w8a16[kernel_class(k.name)] += k.duration / 1e3
    parts["decode_kernel"] = sum(ms for k, ms in by_name.items()
                                 if kernel_class(k) == "decode_kernel")
    per = lambda x: x / WINDOW  # noqa: E731
    return {
        "rows": len(prompts), "batch_bucket": eng._batch_bucket(len(prompts)),
        "prefix_bucket": None if split is None else int(split[0].shape[1]),
        "tail_bucket": None if split is None else int(split[2].shape[1]),
        "prompt_bucket": None if split is not None else
        _bucket_tail(max(len(proc.tokenizer.encode(p)) for p in prompts)),
        "steps": n, "seconds": wall, "tok_per_s": len(prompts) * n / wall,
        "decode_step_ms": {"first_16": mean(step_ms[:16]),
                           "window": mean(step_ms[lo - 1:hi - 1]),
                           "last_16": mean(step_ms[-16:]), "all": mean(step_ms)},
        "host_ms_per_step": {"window": mean(host_ms[lo - 1:hi - 1]),
                             "all": mean(host_ms)},
        "profiled_wall_ms_per_step": (marks["t1"] - marks["t0"]) * 1e3 / WINDOW,
        "device_ms_per_step": per(total),
        "device_busy_share_unprofiled": per(total) / mean(step_ms[lo - 1:hi - 1]),
        "device_ms_per_step_by_part": {k: per(v) for k, v in parts.items()},
        "w8a16_ms_per_step": {k: per(v) for k, v in w8a16.items()
                              if k != "decode_kernel"},
        "other_ms_per_step": per(total - sum(parts.values())),
        "top_kernels_ms_per_step": {
            k[:90]: per(v) for k, v in sorted(by_name.items(),
                                              key=lambda kv: -kv[1])[:15]},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--new-tokens", type=int, default=128)
    ap.add_argument("--cases", default="step1,step1_plain,step2,step4a")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_text: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    build.build_all()
    for name, mod, attr in PARTS:
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            with torch.profiler.record_function(_name):
                return _fn(*a, **kw)

        setattr(mod, attr, wrapped)
    cfg = janus.JANUS_PRO_7B
    model = janus.JanusModel.init(cfg, seed=42, quantize="int8", device="cuda",
                                  vision=False)
    proc = Processor(ByteTokenizer(cfg.language.vocab_size))
    result = {"card": smi, "new_tokens": args.new_tokens,
              "eos_check_every": TextGenEngine.EOS_CHECK_EVERY,
              "top_p_k": sampling.TOP_P_K}
    all_cases = cases()
    for name in args.cases.split(","):
        prompts, gen, shared = all_cases[name]
        torch.cuda.reset_peak_memory_stats()
        result[name] = profile_case(model, proc, prompts, gen, shared,
                                    args.new_tokens)
        result[name]["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(name, json.dumps(result[name], indent=1), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_text.json"), "w") as f:
        json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
