"""Step 2 — pairwise prompt perturbation (counterpart of
``ospo_tpu/pipeline/step2.py``): (a) contrastive negative prompts, (b) both
prompts densified into long prompts that share a scene.

Per template-pure batch, the three perturbation variants are generated as
three seeded calls (seeds ``seed_list`` [0, 1, 2] are part of the data
protocol); answers are parsed on the reference's anchors into
``negative_prompt.json``, then ``long_prompt.json``.  A finished
``negative_prompt.json`` is loaded instead of running 2a again.

Run: ``python -m ospo_tpu_torch.pipeline.step2 --cfg_path configs/step2.yaml
[key=value ...]`` (``device=cpu`` to run on the CPU).
"""

from __future__ import annotations

import argparse
import os
import re
from typing import List, Tuple

from ospo_tpu_torch import chat
from ospo_tpu_torch.config import build_config
from ospo_tpu_torch.engine.text_engine import TextGenEngine
from ospo_tpu_torch.io import (process_count, save_json_sharded, set_seed,
                               shard_for_process)
from ospo_tpu_torch.pipeline.datasets import batched_grouped, load_base_dataset
from ospo_tpu_torch.pipeline.model_factory import get_model
from ospo_tpu_torch.pipeline.templates import (get_dense_conversation,
                                               get_negative_conversation)
from ospo_tpu_torch.platform import maybe_init_distributed


def render(system: str, conversation) -> str:
    return chat.apply_sft_template(conversation, system_prompt=system)


# ---------------------------------------------------------------------------
# 2a — negative prompts
# ---------------------------------------------------------------------------


def parse_negative(answer: str) -> str:
    """Anchor parse + post-processing (text_generation.py:157-167)."""
    out = answer.split("Contrastive Prompt: ")[-1].strip()
    if "<pos>" in out:
        out = out.replace("<pos>", "").strip()
    if "Step 1." in out:
        out = ""
    return out


def build_negative_prompts(batch: List[dict], i: int, seed: int):
    """Rendered 2a prompts for perturbation index ``i`` (None where the
    sample has no template).  ``set_seed`` comes first: the spatial
    templates draw words from the global RNG."""
    set_seed(seed)
    prompts, keep = [], []
    for sample in batch:
        p_type = sample["perturbed_method"][i]
        system, conv = get_negative_conversation(
            sample["sub_category"], p_type, sample["prompt"]
        )
        if system is None or conv is None:
            keep.append(False)
            prompts.append(None)
            continue
        keep.append(True)
        prompts.append(render(system, conv))
    return prompts, keep


def _template_key(s: dict):
    return (str(s.get("sub_category", "")),
            tuple(s.get("perturbed_method", ())))


def _template_batches(data: List[dict], bsz: int) -> List[List[dict]]:
    """Template-pure batches: ``batched_grouped`` over a stable sort by
    (sub_category, perturbed_method), which fix the rendered template, so
    each batch shares its few-shot prefix.  Samples are mutated in place,
    so the callers' saved order stays the original."""
    return list(batched_grouped(sorted(data, key=_template_key), bsz,
                                _template_key))


def run_negative(config, engine: TextGenEngine, data: List[dict]) -> List[dict]:
    seed_list = list(config.seed_list)
    done = 0
    for bidx, batch in enumerate(
            _template_batches(data, int(config.batch_size or 8))):
        outputs_by_index: List[List[str]] = []
        for i in range(3):
            prompts, keep = build_negative_prompts(batch, i, seed_list[i])
            live = [p for p in prompts if p is not None]
            answers = iter(engine.generate(live, seed=seed_list[i]) if live else [])
            outputs_by_index.append([
                parse_negative(next(answers)) if k else "" for k in keep
            ])
        for s_idx, sample in enumerate(batch):
            sample["negative_prompt"] = [outputs_by_index[i][s_idx] for i in range(3)]
            done += 1
        print(f"[step2a] batch {bidx}: {done}/{len(data)} samples")
    return list(data)


# ---------------------------------------------------------------------------
# 2b — densification
# ---------------------------------------------------------------------------


def parse_dense(answer: str) -> Tuple[str, str]:
    """'Step 2./Step 4. … Dense:' anchors (text_generation.py:280-306)."""
    base = re.search(r"Step 2\. Prompt 1 Dense: (.+)", answer)
    neg = re.search(r"Step 4\. Prompt 2 Dense: (.+)", answer)
    base_out = base.group(1) if base else ""
    neg_out = neg.group(1) if neg else ""
    if "Step 1." in base_out:
        base_out = ""
    if "Step 1." in neg_out:
        neg_out = ""
    return base_out, neg_out


def build_dense_prompts(batch: List[dict], i: int, seed: int):
    """Rendered 2b prompts for perturbation index ``i`` (None where the 2a
    negative is empty); deterministic per (batch, i)."""
    set_seed(seed)
    prompts, keep = [], []
    for sample in batch:
        negative = sample["negative_prompt"][i]
        if negative == "":
            keep.append(False)
            prompts.append(None)
            continue
        system, conv = get_dense_conversation(
            sample["sub_category"], sample["prompt"], negative
        )
        keep.append(True)
        prompts.append(render(system, conv))
    return prompts, keep


def run_dense(config, engine: TextGenEngine, data: List[dict]) -> List[dict]:
    seed_list = list(config.seed_list)
    done = 0
    for bidx, batch in enumerate(
            _template_batches(data, int(config.batch_size or 8))):
        results: List[List[Tuple[str, str]]] = []
        for i in range(3):
            prompts, keep = build_dense_prompts(batch, i, seed_list[i])
            live = [p for p in prompts if p is not None]
            answers = iter(engine.generate(live, seed=seed_list[i]) if live else [])
            results.append([
                parse_dense(next(answers)) if k else ("", "") for k in keep
            ])
        for s_idx, sample in enumerate(batch):
            sample["long_prompt"] = [results[i][s_idx][0] for i in range(3)]
            sample["negative_long_prompt"] = [results[i][s_idx][1] for i in range(3)]
            done += 1
        print(f"[step2b] batch {bidx}: {done}/{len(data)} samples")
    return list(data)


def main(config) -> None:
    assert len(config.seed_list) == 3, "Please set 3 seeds for 3 perturbation types."
    model, tokenizer, processor = get_model(config)
    engine = TextGenEngine.from_generation_config(
        model, processor, config.generation_config,
        kv_quant=config.get("kv_quant"),
        batch_cap=int(config.batch_size or 0) or None,
        shared_prefix=config.get("shared_prefix"),
    )

    # 2a, unless a finished negative_prompt.json is there to resume from
    data_path = config.data_path or os.path.join(
        os.path.dirname(config.save_path), "step1", "base_prompt.json"
    )
    neg_path = os.path.join(config.save_path, "negative_prompt.json")
    if os.path.exists(neg_path) and process_count() == 1:
        # the saved file already reflects the original run's s_idx/e_idx
        negatives = load_base_dataset(neg_path, None, None)
        print(f"(Step 2) Resuming from existing {neg_path} "
              f"({len(negatives)} samples); skipping 2a.")
    else:
        data = shard_for_process(
            load_base_dataset(data_path, config.get("s_idx"), config.get("e_idx"))
        )
        negatives = run_negative(config, engine, data)
        save_json_sharded(config.save_path, "negative_prompt", negatives)
        print("(Step 2) Negative prompt generation completed.")

    # 2b — densification
    dense = run_dense(config, engine, negatives)
    save_json_sharded(config.save_path, "long_prompt", dense)
    print("(Step 2) Dense prompt generation completed.")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", type=str, default="configs/step2.yaml")
    args, _ = parser.parse_known_args()
    config = build_config(cfg_path=args.cfg_path)
    maybe_init_distributed(config.get("device"))
    main(config)
