"""Inference CLI — text-to-image generation from a (possibly trained)
checkpoint over a prompt list (counterpart of
``ospo_tpu/pipeline/inference.py``).

Reads a JSON list of prompts, generates one image per (prompt, seed) into
``{save_path}/{prompt}_{seed}.png`` (``/`` → ``_``), skips images already on
disk, saves an image whose name the file system refuses (over 255 bytes)
as ``longprompt_{seed}_{n:04d}.png``, records the prompts of failed batches
in ``error_sample.json`` and prints the elapsed minutes.  A kernel that does
not build or launch (``ops.build.KernelError``) fails the run instead, as
does any failed batch under tensor parallel, where model rank 0 alone
decides what is left to draw and writes.
PNGs are written by ``utils/png.write_png`` (no Pillow).

Run: ``python -m ospo_tpu_torch.pipeline.inference [key=value ...]``
(composes ``configs/inference.yaml``; ``--cfg_path`` reads one file
instead; ``device=cpu`` to run on the CPU).
"""

from __future__ import annotations

import argparse
import os
import time
import traceback
from typing import List

from ospo_tpu_torch.config import build_config, compose_config
from ospo_tpu_torch.engine.image_engine import ImageGenEngine
from ospo_tpu_torch.io import read_json, save_json, shard_for_process
from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.ops.build import KernelError
from ospo_tpu_torch.pipeline.datasets import batched
from ospo_tpu_torch.pipeline.model_factory import get_model
from ospo_tpu_torch.platform import maybe_init_distributed
from ospo_tpu_torch.utils.png import write_png


def generate_all(config, engine: ImageGenEngine, prompts: List[str]) -> None:
    os.makedirs(config.save_path, exist_ok=True)
    seeds = config.get("seed") or [0]
    if isinstance(seeds, int):
        seeds = [seeds]
    error_samples = []
    n_long = 0  # running index of the longprompt_* names over the call
    batch_size = int(config.get("batch_size") or 4)
    writes = mesh_lib.model_rank() == 0
    for seed in seeds:
        for batch in batched(prompts, batch_size):
            paths, todo = [], []
            for p in batch:
                fname = f"{p}_{seed}.png".replace("/", "_")
                path = os.path.join(config.save_path, fname)
                if os.path.exists(path):
                    continue
                todo.append(p)
                paths.append(path)
            todo, paths = mesh_lib.broadcast_object((todo, paths))
            if not todo:
                continue
            try:
                images = engine.generate_from_raw_prompts(todo, seed=seed)
            except KernelError:
                raise  # the program is broken, not the batch
            except Exception as e:
                if mesh_lib.model_parallel_size() > 1:
                    raise
                print(f"Error generating batch: {e}")
                traceback.print_exc()
                error_samples.extend(todo)
                continue
            if not writes:
                continue
            # one image at a time: an overlong name costs that name only
            for img, path, p in zip(images, paths, todo):
                try:
                    write_png(path, img)
                except OSError:
                    alt = os.path.join(config.save_path,
                                       f"longprompt_{seed}_{n_long:04d}.png")
                    n_long += 1
                    try:
                        write_png(alt, img)
                        print(f"# overlong prompt filename — saved {alt}")
                    except Exception as e:
                        print(f"Error saving {path}: {e}")
                        error_samples.append(p)
                except Exception as e:
                    print(f"Error saving {path}: {e}")
                    error_samples.append(p)
    if error_samples:
        save_json(config.save_path, "error_sample", error_samples)


def build_engine(config, model, processor) -> ImageGenEngine:
    """The engine ``main`` serves with (``ospo_tpu/pipeline/inference.py
    :86-102``).  The port has no ``decode_kernel`` key: an ``shbd``
    model-dtype or int8 cache runs the decode kernel, and
    ``decode_segments`` bounds the other caches' plain reads."""
    gen_cfg = config.get("generation_config") or {}
    return ImageGenEngine(
        model, processor,
        cfg_weight=float(gen_cfg.get("cfg_weight", 5.0)),
        temperature=float(gen_cfg.get("temperature", 1.0)),
        image_token_num=model.cfg.num_gen_tokens,
        img_size=model.cfg.gen_image_size,
        patch_size=model.cfg.vq.downsample_factor,
        kv_quant=config.get("kv_quant"),
        # growing windows of the plain cache reads (no-op on the kernel's
        # shbd cache and for SJD); only unset falls back to 8
        decode_segments=(8 if config.get("decode_segments") is None
                         else int(config.get("decode_segments"))),
        speculative=int(config.get("speculative") or 0),
        kv_layout=config.get("kv_layout"),
        batch_cap=int(config.get("batch_size") or 0) or None,
    )


def main(config) -> None:
    start = time.time()
    model, _, processor = get_model(config)
    engine = build_engine(config, model, processor)
    prompts = shard_for_process(read_json(config.data_path))
    generate_all(config, engine, prompts)
    print(f"Elapsed: {(time.time() - start) / 60:.2f} minutes")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", type=str, default=None)
    parser.add_argument("--config_dir", type=str, default="configs")
    parser.add_argument("--config_name", type=str, default="inference")
    args, _ = parser.parse_known_args()
    if args.cfg_path:
        cfg = build_config(cfg_path=args.cfg_path)
    else:
        cfg = compose_config(args.config_dir, args.config_name)
    maybe_init_distributed(cfg.get("device"))
    main(cfg)
