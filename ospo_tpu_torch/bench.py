"""The port's benchmark entry point: one JSON line per run.

    python -m ospo_tpu_torch.bench --mode step3|train|text|score \
        --preset tiny|1b|7b [--device cpu] [settings]

The counterpart of the JAX package's ``bench.py``, with its modes, metric
names and units, and its ``OSPO_BENCH_*`` settings as flags with the same
defaults:

- ``step3`` — ``img-tokens/sec/chip``: CFG text-to-image decode through
  :class:`ImageGenEngine` (prompt prefill, then ``--tokens`` sampled image
  tokens; no VQ decode), int8 weights and int8 KV by default, batch 24
  (4 with unquantized weights), byte prompts of ``--prompt-len`` tokens;
- ``train`` — ``simpo-samples/sec/chip``: :meth:`SimPOTrainer._step` (VQ
  encode, the 2B forward under remat with the flash kernels, SimPO,
  AdamW) on random pixels,
  LoRA r32 (``--full``: full fine-tune of the language model, the
  ``configs/step5.yaml`` freeze matrix), batch 2, text length 32,
  ``--quantize int8`` / ``w8a8`` for a quantized frozen trunk
  (``quantize_base``);
- ``text`` — ``text-tokens/sec/chip``: :meth:`TextGenEngine.generate_ids`,
  64 rows of one 120-byte prompt, 256 new tokens, int8 weights and KV;
- ``score`` — ``pref-pairs/hour/chip``: :meth:`ScoringEngine.
  score_images_multi` over chunks of 16 random images with 2–4 questions,
  the next chunk prepared on a prefetch thread; 6 images make a pair.

Each mode makes one warm-up call (it also builds the kernels), then times
three and keeps the fastest, as ``bench.py`` does.  The line also holds the
batch, the preset, the call or step time, the peak device memory and the
card's name and power limit.  Weights are random, from seed 0.  There is no
batch ladder: a failure prints the error and exits with status 1, and no
result line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

METRICS = {
    "step3": ("img-tokens/sec/chip", "tok/s"),
    "train": ("simpo-samples/sec/chip", "samples/s"),
    "text": ("text-tokens/sec/chip", "tok/s"),
    "score": ("pref-pairs/hour/chip", "pairs/h"),
}
N_TIMED = 3
STEP5_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "step5.yaml")


def card() -> str | None:
    """``name, power limit`` as nvidia-smi prints them, or None without it."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device) -> list:
    """One warm-up call, then ``N_TIMED`` timed calls ``fn(i)`` (seconds)."""
    fn(0)
    _sync(device)
    times = []
    for i in range(1, N_TIMED + 1):
        t0 = time.perf_counter()
        fn(i)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times


def _config(preset: str):
    from ospo_tpu_torch.models import janus as janus_lib

    if preset == "7b":
        return janus_lib.JANUS_PRO_7B
    if preset == "1b":
        return janus_lib.JANUS_PRO_1B
    return janus_lib.tiny_janus_config()


def _processor(cfg, image_size: int):
    from ospo_tpu_torch.image_processing import ImageProcessor
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import ByteTokenizer

    # byte ids (< 512) index every preset's vocabulary
    return Processor(ByteTokenizer(vocab_size=min(512, cfg.language.vocab_size)),
                     ImageProcessor(image_size=image_size),
                     num_image_tokens=cfg.num_image_tokens)


def _model(cfg, device, quantize, **parts):
    from ospo_tpu_torch.models import janus as janus_lib

    return janus_lib.JanusModel.init(cfg, seed=0, quantize=quantize,
                                     device=device, **parts)


def bench_step3(args) -> dict:
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine

    cfg = _config(args.preset)
    batch = args.batch or (24 if args.quantize else 4)
    model = _model(cfg, args.device, args.quantize, lm_head=False,
                   understanding=False)
    engine = ImageGenEngine(
        model, _processor(cfg, cfg.gen_image_size), cfg_weight=5.0,
        temperature=1.0, image_token_num=args.tokens,
        img_size=cfg.gen_image_size, patch_size=cfg.vq.downsample_factor,
        kv_quant=args.kv, decode_segments=8, batch_cap=batch)
    prompts = ["A" * args.prompt_len] * batch  # byte tokenizer: one id a byte
    out = {}

    def call(i):
        out["tokens"] = engine.generate_tokens(prompts, seed=i)

    dt = min(_timed(call, model.device))
    if out["tokens"].shape != (batch, args.tokens):
        raise RuntimeError(f"step3 returned tokens {out['tokens'].shape}")
    return {"value": batch * args.tokens / dt, "batch": batch,
            "call_ms": dt * 1e3, "step_ms": dt / args.tokens * 1e3,
            "tokens": args.tokens, "prompt_len": args.prompt_len,
            "quantize": args.quantize or None, "kv": args.kv or None}


def bench_train(args) -> dict:
    from ospo_tpu_torch.config import Config, load_yaml
    from ospo_tpu_torch.train.trainer import SimPOTrainer

    cfg = _config(args.preset)
    batch = args.batch or 2
    # the SimPO step never runs the understanding tower or lm_head; the
    # trainer quantizes the frozen trunk itself (quantize_base)
    model = _model(cfg, args.device, "", lm_head=False, understanding=False)
    experiment = {"seed": 0, "max_training_steps": 10, "log_steps": 100,
                  "gradient_checkpointing": True, "attn_impl": "flash",
                  "quantize_base": args.quantize or False}
    if args.full:
        # step 5's freeze matrix: the language model trains
        experiment["freeze"] = load_yaml(STEP5_YAML)["experiment"]["freeze"]
    config = Config.from_nested({
        "use_peft": not args.full,
        "lora": {"lora_rank": 32, "lora_alpha": 64, "lora_dropout": 0.05},
        "optimizer": {"init_lr": 4e-5, "scheduler_type": "constant"},
        "experiment": experiment,
        "algo": {"beta": 10, "gamma_beta_ratio": 0.5, "loss_type": "sigmoid"},
    })
    trainer = SimPOTrainer(config, model, _processor(cfg, cfg.gen_image_size))
    dev, side = model.device, cfg.gen_image_size
    gen = torch.Generator(device=dev)
    text = torch.ones((batch, args.text_len), dtype=torch.long, device=dev)
    mask = torch.ones((batch, args.text_len), device=dev)
    metrics = {}

    def step(i):
        # fresh pixels in [-1, 1] every step
        gen.manual_seed(i)
        px = torch.rand((2, batch, side, side, 3), device=dev, generator=gen)
        metrics.update(trainer._step(text, mask, px[0] * 2 - 1, px[1] * 2 - 1,
                                     dropout_seed=i))

    dt = min(_timed(step, dev))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"train step loss {loss}")
    return {"value": batch / dt, "batch": batch, "step_ms": dt * 1e3,
            "text_len": args.text_len, "loss": loss,
            "train_mode": "full" if args.full else "lora",
            "quantize_base": args.quantize or None}


def bench_text(args) -> dict:
    from ospo_tpu_torch.engine.text_engine import TextGenEngine

    cfg = _config(args.preset)
    batch = args.batch or 64
    model = _model(cfg, args.device, args.quantize, vision=False)
    engine = TextGenEngine(model, _processor(cfg, cfg.image_size),
                           max_new_tokens=args.tokens, temperature=1.0,
                           do_sample=True, kv_quant=args.kv)
    prompts = ["A" * args.prompt_len] * batch
    out = {}

    def call(i):
        out["ids"] = engine.generate_ids(prompts, seed=i)

    dt = min(_timed(call, model.device))
    if out["ids"].shape != (batch, args.tokens):
        raise RuntimeError(f"text returned ids {out['ids'].shape}")
    return {"value": batch * args.tokens / dt, "batch": batch,
            "call_ms": dt * 1e3, "step_ms": dt / args.tokens * 1e3,
            "tokens": args.tokens, "prompt_len": args.prompt_len,
            "quantize": args.quantize or None, "kv": args.kv or None}


# question lists of different lengths (bench.py's), one per item of 6 images
QUESTION_SETS = [
    ["Is there a black umbrella?", "Is the umbrella open?",
     "Does this image accurately represent the prompt?"],
    ["Is there a red car?", "Is it parked?", "Is it daytime?",
     "Does this image accurately represent the prompt?"],
    ["Is there a dog?", "Does this image accurately represent the prompt?"],
]


def bench_score(args) -> dict:
    from ospo_tpu_torch.engine.scoring import ScoringEngine
    from ospo_tpu_torch.utils.prefetch import prefetch_iter

    cfg = _config(args.preset)
    rows = args.batch or 16
    model = _model(cfg, args.device, args.quantize)
    engine = ScoringEngine(model, _processor(cfg, cfg.image_size),
                           kv_quant=args.kv)
    side = cfg.image_size
    rng = np.random.default_rng(0)

    def prep(base):
        imgs = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
                for _ in range(rows)]
        qs = [QUESTION_SETS[(base + j) // 6 % len(QUESTION_SETS)]
              for j in range(rows)]
        return imgs, qs, engine.prepare_shared_multi(imgs, qs)

    # the warm-up chunk, then N_TIMED chunks whose preparation runs on the
    # prefetch thread under the previous chunk's device work; each time is
    # one chunk's wall clock (waiting for its preparation included)
    times, last = [], None
    for _, (imgs, qs, p) in prefetch_iter(
            [k * rows for k in range(N_TIMED + 1)], prep):
        scores = engine.score_images_multi(imgs, qs, prep=p)
        _sync(model.device)
        now = time.perf_counter()
        if last is not None:
            times.append(now - last)
        last = now
    if len(scores) != rows:
        raise RuntimeError(f"score returned {len(scores)} results for {rows}")
    dt = min(times)
    return {"value": rows / dt / 6 * 3600, "batch": rows,
            "call_ms": dt * 1e3, "images_per_sec": rows / dt,
            "quantize": args.quantize or None, "kv": args.kv or None,
            "counts": engine.counts}


MODES = {"step3": bench_step3, "train": bench_train, "text": bench_text,
         "score": bench_score}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=sorted(MODES), default="step3")
    p.add_argument("--preset", choices=("tiny", "1b", "7b"), default="7b")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=None,
                   help="CFG pairs (step3), pairs (train), rows (text), "
                        "images a chunk (score); default per mode")
    p.add_argument("--tokens", type=int, default=None,
                   help="image tokens (step3, default 576) or new text "
                        "tokens (text, default 256)")
    p.add_argument("--prompt-len", type=int, default=None,
                   help="prompt bytes (step3 64, text 120)")
    p.add_argument("--quantize", default=None,
                   help="trunk weights: int8 (default for step3, text, "
                        "score), w8a8, int4, int4g, int4n or none; train: "
                        "the frozen trunk (quantize_base: int8 or w8a8, "
                        "default none)")
    p.add_argument("--kv", default="int8",
                   help="KV cache: int8, int4 (step3, text) or bf16")
    p.add_argument("--text-len", type=int, default=32,
                   help="train: text tokens a sample")
    p.add_argument("--full", action="store_true",
                   help="train: full fine-tune of the language model")
    args = p.parse_args(argv)
    from ospo_tpu_torch.ops import quant
    from ospo_tpu_torch.platform import resolve_device

    args.device = resolve_device(args.device)
    if args.quantize is None:
        args.quantize = "" if args.mode == "train" else "int8"
    args.quantize = quant.quant_mode(args.quantize)
    args.kv = quant.parse_kv_quant(args.kv)
    if args.tokens is None:
        args.tokens = 576 if args.mode == "step3" else 256
    if args.prompt_len is None:
        args.prompt_len = 64 if args.mode == "step3" else 120
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    metric, unit = METRICS[args.mode]
    if args.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(args.device)
    try:
        result = MODES[args.mode](args)
    except Exception as e:
        print(f"bench {args.mode} failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    peak = (torch.cuda.max_memory_allocated(args.device)
            if args.device.type == "cuda" else None)
    print(json.dumps({"metric": metric, "value": result.pop("value"),
                      "unit": unit, "preset": args.preset,
                      "device": str(args.device), **result,
                      "max_memory_allocated": peak, "card": card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
