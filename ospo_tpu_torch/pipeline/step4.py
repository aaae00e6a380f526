"""Step 4 — self-VQA, the question half (counterpart of
``ospo_tpu/pipeline/step4.py``): (a) decompose each long prompt into yes/no
questions plus the fixed global question, writing ``vqa_prompt.json``
(skipped if it exists).  (b), scoring the step-3 images and selecting the
preference pairs, comes with the understanding slice (ROADMAP.md); asking
for it raises.

Run: ``python -m ospo_tpu_torch.pipeline.step4 --cfg_path configs/step4.yaml
image_path=null [key=value ...]`` (``device=cpu`` to run on the CPU); with
an ``image_path`` set, 4b is asked for.
"""

from __future__ import annotations

import argparse
import os
from typing import List

from ospo_tpu_torch import chat
from ospo_tpu_torch.config import build_config
from ospo_tpu_torch.engine.text_engine import TextGenEngine
from ospo_tpu_torch.io import read_json, save_json_sharded, set_seed, shard_for_process
from ospo_tpu_torch.pipeline.datasets import batched_grouped
from ospo_tpu_torch.pipeline.model_factory import get_model
from ospo_tpu_torch.pipeline.templates import get_vqa_conversation

GLOBAL_QUESTION = (
    "This image is generated by a prompt: {}. "
    "Does this image accurately represent the prompt?"
)


def parse_questions(answer: str, prompt: str) -> List[str]:
    """'Questions: ' anchor split + global question append (vqa.py:61-70)."""
    tail = answer.split("Questions: ")[-1]
    questions = [t.strip() + "?" for t in tail.split("?") if t.strip().rstrip(".")]
    questions.append(GLOBAL_QUESTION.format(prompt.rstrip(".")))
    return questions


def build_question_prompts(batch: List[dict]) -> List[str]:
    prompts = []
    for sample in batch:
        system, conv = get_vqa_conversation(sample["category"], sample["prompt"])
        prompts.append(chat.apply_sft_template(conv, system_prompt=system))
    return prompts


def run_question_gen(config, engine: TextGenEngine, data: List[dict]) -> List[dict]:
    """Batches within category groups (one few-shot template a batch, so
    the shared-prefix program stores it once); the questions land on the
    samples in place, in the original order."""
    key = lambda s: str(s.get("category", ""))  # noqa: E731
    batches = list(batched_grouped(sorted(data, key=key),
                                   int(config.batch_size or 8), key))
    done = 0
    for batch in batches:
        answers = engine.generate(build_question_prompts(batch),
                                  seed=int(config.seed or 42))
        for sample, answer in zip(batch, answers):
            sample["question"] = parse_questions(answer, sample["prompt"])
            done += 1
        print(f"[step4a] {done}/{len(data)} samples")
    return list(data)


def main(config) -> None:
    set_seed(int(config.seed or 42))
    vqa_path = os.path.join(config.save_path, "vqa_prompt.json")
    if not os.path.exists(vqa_path):
        model, tokenizer, processor = get_model(config)
        data_path = config.data_path or os.path.join(
            os.path.dirname(config.save_path), "step2", "long_prompt.json"
        )
        data = shard_for_process(
            read_json(data_path)[config.get("s_idx") : config.get("e_idx")]
        )
        text_engine = TextGenEngine.from_generation_config(
            model, processor, config.generation_config,
            kv_quant=config.get("kv_quant"),
            batch_cap=int(config.batch_size or 0) or None,
            shared_prefix=config.get("shared_prefix"),
        )
        questions = run_question_gen(config, text_engine, data)
        save_json_sharded(config.save_path, "vqa_prompt", questions)
        print("(Step 4) Decompositional Question generation completed.")
    if config.get("image_path"):
        raise NotImplementedError(
            "step 4b (scoring the step-3 images and selecting pairs) comes "
            "with the understanding slice in ROADMAP.md (queue 1); run 4a "
            "alone with image_path=null")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", type=str, default="configs/step4.yaml")
    args, _ = parser.parse_known_args()
    main(build_config(cfg_path=args.cfg_path))
