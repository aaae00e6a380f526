"""Step 1 — category-wise element and base-prompt generation (counterpart of
``ospo_tpu/pipeline/step1.py``).

Per category, sample a batch of answers to the category's few-shot prompt
per iteration until ``max_len`` unique elements exist, write
``{category}_element.json``; once all seven element files exist, build the
combinatorial ``base_prompt.json``.

Run: ``python -m ospo_tpu_torch.pipeline.step1 --cfg_path configs/step1.yaml
[category=object] [key=value ...]`` (``device=cpu`` to run on the CPU).
"""

from __future__ import annotations

import argparse
import os
import random
import re
from typing import Dict, List

from ospo_tpu_torch import chat
from ospo_tpu_torch.config import build_config
from ospo_tpu_torch.engine.text_engine import TextGenEngine
from ospo_tpu_torch.io import (data_index, merge_element_sets, process_index,
                               read_json, save_json, set_seed)
from ospo_tpu_torch.models.llama import fold_seed
from ospo_tpu_torch.pipeline.model_factory import get_model
from ospo_tpu_torch.pipeline.templates import get_element_conversation
from ospo_tpu_torch.platform import maybe_init_distributed
from ospo_tpu_torch.utils.english import number_to_words, plural

DEFAULT_MAX_LEN = {"object": 120, "spatial": 40, "non-spatial": 4000, "complex": 4000}
ELEMENT_FILES = (
    "object_element.json", "color_element.json", "shape_element.json",
    "texture_element.json", "spatial_element.json", "non-spatial_element.json",
    "complex_element.json",
)
STOP_WORDS = ["and", "or", "/", "-", "color", "shape", "texture", "spatial"]


def parse_element_answer(answer: str, category: str) -> List[str]:
    """Answer post-processing (ospo/wrapper/text_generation.py:45-60)."""
    if category in ("non-spatial", "complex"):
        out = answer.strip().lower()
        return [out] if out else []
    parts = [a.strip().lower() for a in answer.split(",")]
    parts = [a for a in parts if a and re.fullmatch(r"[a-zA-Z ]+", a)]
    return [w for w in parts if all(stop not in w for stop in STOP_WORDS)]


def generate_elements(config, model, processor) -> List[str]:
    """Sample ``batch_size`` answers per iteration; iteration ``it`` draws
    from a generator seeded with ``fold_seed(seed, it * 1000 +
    data_index())`` (the reference folds the process index into its key;
    under tensor parallel a model group's ranks share theirs)."""
    category = config.category
    max_len = config.max_len or DEFAULT_MAX_LEN.get(category, 70)
    engine = TextGenEngine.from_generation_config(
        model, processor, config.generation_config,
        kv_quant=config.get("kv_quant"),
        batch_cap=int(config.batch_size or 0) or None,
        shared_prefix=config.get("shared_prefix"),
    )
    system, conversation = get_element_conversation(category)
    prompt = chat.apply_sft_template(conversation, system_prompt=system)

    batch = int(config.batch_size or 1)
    elements: set = set()
    seed = int(config.seed or 42)
    for it in range(max_len):
        if len(elements) >= max_len:
            break
        answers = engine.generate(
            [prompt] * batch, seed=fold_seed(seed, it * 1000 + data_index()))
        for ans in answers:
            elements.update(parse_element_answer(ans, category))
    # saved untruncated, like the reference; sorted for deterministic files
    return sorted(elements)


# ---------------------------------------------------------------------------
# combinatorial base-prompt construction (ospo/step1.py:36-177)
# ---------------------------------------------------------------------------


def construct_prompt(object_elements: List[str], binding_elements,
                     generate_type: str, generate_num: int = 1000) -> List[str]:
    prompt_set: set = set()
    fmt = {
        "attribute1": "A {} {}",
        "attribute2": "A {} {} and a {} {}",
        "layout1": "A {} {} a {}",
        "layout2": "{} {}",
        "layout3": "{} {} and {} {}",
    }

    if generate_type != "layout2":
        guard = 0
        while len(prompt_set) < generate_num:
            guard += 1
            if guard > generate_num * 1000:
                break  # element pool too small to reach the quota
            if generate_type == "attribute1":
                obj = random.choice(object_elements)
                binding = random.choice(binding_elements)
                prompt = fmt[generate_type].format(
                    binding.strip().lower(), obj.strip().lower()
                )
            elif generate_type == "attribute2":
                objs = random.sample(object_elements, 2)
                pools = random.choices(binding_elements, k=2)
                for _ in range(100):  # bounded retry (tiny pools can collide)
                    b1 = random.choice(pools[0])
                    b2 = random.choice(pools[1])
                    if b1 != b2:
                        break
                prompt = fmt[generate_type].format(
                    b1.strip().lower(), objs[0].strip().lower(),
                    b2.strip().lower(), objs[1].strip().lower(),
                )
            elif generate_type == "layout1":
                objs = random.sample(object_elements, 2)
                binding = random.choice(binding_elements)
                prompt = fmt[generate_type].format(
                    objs[0].strip().lower(), binding.strip().lower(),
                    objs[1].strip().lower(),
                )
            elif generate_type == "layout3":
                objs = random.sample(object_elements, 2)
                n1, n2 = random.randint(1, 5), random.randint(1, 5)
                q1 = "A" if n1 == 1 else number_to_words(n1).capitalize()
                o1 = objs[0] if n1 == 1 else plural(objs[0].strip())
                q2 = "a" if n2 == 1 else number_to_words(n2)
                o2 = objs[1] if n2 == 1 else plural(objs[1].strip())
                prompt = fmt[generate_type].format(q1, o1, q2, o2)
            prompt_set.add(prompt)
        prompts = list(prompt_set)
    else:  # layout2: counted singles, 1..29 of each object
        for num in range(1, 30):
            for obj in object_elements:
                obj = obj.strip()
                if num == 1:
                    prompt = f"A {obj}"
                else:
                    prompt = fmt["layout2"].format(
                        number_to_words(num).capitalize(), plural(obj)
                    )
                prompt_set.add(prompt)
                if len(prompt_set) == generate_num:
                    break
            if len(prompt_set) == generate_num:
                break
        prompts = list(prompt_set)
        random.shuffle(prompts)

    print(f"*** Generated [{generate_type}] prompt: {len(prompts)} ***")
    return prompts


CATEGORY2IDX = {"attribute": 0, "layout": 1, "non-spatial": 2, "complex": 3}


def combine_prompt(config) -> None:
    base = config.save_path
    obj = read_json(os.path.join(base, "object_element.json"))
    color = read_json(os.path.join(base, "color_element.json"))
    shape = read_json(os.path.join(base, "shape_element.json"))
    texture = read_json(os.path.join(base, "texture_element.json"))
    spatial = read_json(os.path.join(base, "spatial_element.json"))
    non_spatial = read_json(os.path.join(base, "non-spatial_element.json"))
    complex_ = read_json(os.path.join(base, "complex_element.json"))
    attributes = [color, shape, texture]

    buckets: Dict[str, List[dict]] = {
        "attribute": [], "layout": [], "non-spatial": [], "complex": []
    }
    for sub_category, num in (config.category_num or {}).items():
        if sub_category == "attribute1_color":
            cat, plist = "attribute", construct_prompt(obj, color, "attribute1", num)
        elif sub_category == "attribute1_shape":
            cat, plist = "attribute", construct_prompt(obj, shape, "attribute1", num)
        elif sub_category == "attribute1_texture":
            cat, plist = "attribute", construct_prompt(obj, texture, "attribute1", num)
        elif sub_category == "attribute2":
            cat, plist = "attribute", construct_prompt(obj, attributes, "attribute2", num)
        elif sub_category == "layout1":
            cat, plist = "layout", construct_prompt(obj, spatial, "layout1", num)
        elif sub_category == "layout2":
            cat, plist = "layout", construct_prompt(obj, [], "layout2", num)
        elif sub_category == "layout3":
            cat, plist = "layout", construct_prompt(obj, [], "layout3", num)
        elif sub_category == "non-spatial":
            cat, plist = sub_category, non_spatial
            assert len(plist) == num, (
                f"Expected {num} prompts for non-spatial, but got {len(plist)}."
            )
        elif sub_category == "complex":
            cat, plist = sub_category, complex_
            assert len(plist) == num, (
                f"Expected {num} prompts for complex, but got {len(plist)}."
            )
        else:
            raise ValueError(f"unknown sub_category {sub_category}")
        for p in plist:
            buckets[cat].append({
                "prompt": p.strip(),
                "category": cat,
                "sub_category": sub_category,
            })

    output: List[dict] = []
    for cat, samples in buckets.items():
        for i, s in enumerate(samples):
            s["item_id"] = f"{CATEGORY2IDX[cat]}{i:06d}"
        output.extend(samples)
    print(f"\n*** Total number of base prompt (including non-spatial, complex): "
          f"{len(output)} ***")
    save_json(config.save_path, "base_prompt",
              sorted(output, key=lambda x: int(x["item_id"])))


def main(config) -> None:
    set_seed(int(config.seed or 42))
    if not config.save_path:
        # fail before the generation pass: every later write needs it
        raise ValueError("step1 requires save_path")
    os.makedirs(config.save_path, exist_ok=True)

    model, tokenizer, processor = get_model(config)
    elements = generate_elements(config, model, processor)
    merged = merge_element_sets(elements)
    if process_index() == 0:
        save_json(config.save_path, f"{config.category}_element", list(merged))
        print(f"# Generated [{config.category}] elements: {len(merged)}")

    if process_index() == 0 and all(
        os.path.exists(os.path.join(config.save_path, f)) for f in ELEMENT_FILES
    ):
        print("All elements and prompts are generated. Start combining all.")
        try:
            combine_prompt(config)
            print("(Step 1) Base prompt generation completed.")
        except Exception as e:  # element files may need curation first
            import traceback

            print(f"combine_prompt failed ({e}); element files are saved — "
                  "fix quotas/elements and re-run any category to combine.")
            traceback.print_exc()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", type=str, default="configs/step1.yaml")
    parser.add_argument("--category", type=str, default="object")
    args, _ = parser.parse_known_args()
    config = build_config(cfg_path=args.cfg_path)
    maybe_init_distributed(config.get("device"))
    if config.category is None:
        config.category = args.category
    print("# Category:", config.category)
    main(config)
