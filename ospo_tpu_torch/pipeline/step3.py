"""Step 3 — image generation, the port's main path (counterpart of
``ospo_tpu/pipeline/step3.py``).

For each item, 3 base + 3 negative images (seed_list[i] for perturbation
index i), saved as ``{save_path}/{base|negative}/{category}/{item_id}/
{i:02d}.png`` with ``metadata.json`` beside them; images already on disk are
skipped (restart resume).  The decode runs on :class:`ImageGenEngine`; PNG
fetch and encode run on two writer threads, at most three groups in flight.

Run: ``python -m ospo_tpu_torch.pipeline.step3 --cfg_path configs/step3.yaml
[key=value ...]`` (``device=cpu`` to run on the CPU).
"""

from __future__ import annotations

import argparse
import os
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import List

import torch

from ospo_tpu_torch.config import build_config
from ospo_tpu_torch.engine.image_engine import ImageGenEngine
from ospo_tpu_torch.io import save_json, shard_for_process
from ospo_tpu_torch.pipeline.datasets import batched, load_base_dataset
from ospo_tpu_torch.pipeline.model_factory import get_model
from ospo_tpu_torch.processing import t2i_prompt
from ospo_tpu_torch.utils.png import write_png
from ospo_tpu_torch.utils.profiling import ThroughputMeter


def save_images(images, paths: List[str]) -> None:
    for img, path in zip(images, paths):
        try:
            write_png(path, img)
        except OSError:  # over-long file name fallback (reference quirk)
            write_png(f"longprompt_{os.path.basename(path)}", img)


def run_step3(config, engine: ImageGenEngine, processor, data: List[dict]) -> dict:
    """Generate and write the images of ``data``; returns run statistics
    (groups, images, image tokens, seconds)."""
    batch_size = int(config.batch_size or 4)
    seed_list = list(config.seed_list)
    done = failed_batches = n_batches = n_groups = n_images = 0
    meter = ThroughputMeter()
    png_pool = ThreadPoolExecutor(max_workers=2)
    pending = []
    write_lock = threading.Lock()
    writer_stats = {"ok": 0, "failed": 0}
    if engine.device.type == "cuda":  # model set-up is not serving time
        torch.cuda.synchronize(engine.device)
    t0 = time.time()
    for batch in batched(data, batch_size):
        n_batches += 1
        prompt_lists = [[] for _ in range(6)]
        path_lists = [[] for _ in range(6)]
        try:
            for sample in batch:
                groups = (("base", sample["long_prompt"], 0),
                          ("negative", sample["negative_long_prompt"], 3))
                for prompt_type, prompts, offset in groups:
                    save_dir = os.path.join(config.save_path, prompt_type,
                                            sample["category"], sample["item_id"])
                    os.makedirs(save_dir, exist_ok=True)
                    save_json(save_dir, "metadata", sample)
                    for i in range(3):
                        prompt = prompts[i]
                        if not prompt:
                            continue
                        final_path = os.path.join(save_dir, f"{i:02d}.png")
                        if os.path.exists(final_path):  # restart resume
                            continue
                        prompt_lists[i + offset].append(t2i_prompt(processor, prompt))
                        path_lists[i + offset].append(final_path)

            for idx in range(6):
                if not prompt_lists[idx]:
                    continue
                # uint8 pixels stay on the device; a writer thread fetches
                # them while the device decodes the next group
                device_images = engine.generate_images_device(
                    prompt_lists[idx], seed=seed_list[idx % 3])
                n_real = len(path_lists[idx])

                def fetch_and_save(dev=device_images, paths=path_lists[idx],
                                   n=n_real):
                    try:
                        save_images(dev[:n].cpu().numpy(), paths)
                        with write_lock:
                            writer_stats["ok"] += 1
                    except Exception as e:  # one group, not the stage
                        with write_lock:
                            writer_stats["failed"] += 1
                        print(f"Error in step3 fetch/save ({paths[0]}): {e}")
                        traceback.print_exc()

                pending.append(png_pool.submit(fetch_and_save))
                # backpressure: each pending group pins its device images
                if len(pending) >= 3:
                    pending[-3].result()
                n_groups += 1
                n_images += n_real
                meter.update(n_real * engine.image_token_num)
        except Exception as e:  # per-batch fault tolerance (reference parity)
            failed_batches += 1
            print(f"Error in step3 batch: {e}")
            traceback.print_exc()
        done += len(batch)
        print(f"[step3] {done}/{len(data)} items ({meter.rate:.1f} img-tok/s)")
    for fut in pending:  # join the writers (they trap their own errors)
        fut.result()
    png_pool.shutdown()
    seconds = time.time() - t0
    # a bad sample must not kill a long run, but a run where EVERY batch
    # failed is an environment problem — refuse to complete it
    if n_batches and failed_batches == n_batches:
        raise RuntimeError(
            f"step3: all {n_batches} batches failed — aborting instead of "
            "writing an empty output tree (see errors above)")
    if writer_stats["failed"]:
        total = writer_stats["failed"] + writer_stats["ok"]
        print(f"# step3: {writer_stats['failed']}/{total} fetch/save groups "
              "failed (see tracebacks above)")
        if writer_stats["failed"] > writer_stats["ok"]:
            raise RuntimeError(
                f"step3: {writer_stats['failed']}/{total} fetch/save groups "
                "failed — aborting instead of completing a mostly-empty "
                "output tree")
    return {"groups": n_groups, "images": n_images,
            "image_tokens": n_images * engine.image_token_num,
            "failed_batches": failed_batches, "seconds": seconds}


def main(config) -> dict:
    if len(config.seed_list or ()) != 3:
        raise ValueError("Please set 3 seeds for 3 perturbation types.")
    model, tokenizer, processor = get_model(config)
    gen_cfg = config.generation_config or {}
    engine = ImageGenEngine(
        model, processor,
        cfg_weight=float(gen_cfg.get("cfg_weight", 5.0)),
        temperature=float(gen_cfg.get("temperature", 1.0)),
        image_token_num=model.cfg.num_gen_tokens,
        img_size=model.cfg.gen_image_size,
        patch_size=model.cfg.vq.downsample_factor,
        kv_quant=config.get("kv_quant"),
        speculative=int(config.get("speculative") or 0),
        kv_layout=config.get("kv_layout"),
        batch_cap=int(config.batch_size or 0) or None,
    )
    data_path = config.data_path or os.path.join(
        os.path.dirname(config.save_path), "step2", "long_prompt.json")
    data = shard_for_process(
        load_base_dataset(data_path, config.get("s_idx"), config.get("e_idx")))
    stats = run_step3(config, engine, processor, data)
    print("(Step 3) Image generation completed.")
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", type=str, default="configs/step3.yaml")
    args, _ = parser.parse_known_args()
    main(build_config(cfg_path=args.cfg_path))
