"""Step 4 — self-VQA preference-pair selection (counterpart of
``ospo_tpu/pipeline/step4.py``): (a) decompose each long prompt into yes/no
questions plus the fixed global question, writing ``vqa_prompt.json``
(skipped if it exists); (b) score every step-3 image under ``image_path``
with the model's own understanding pathway (``engine/scoring.py``) and
select (chosen, rejected) pairs by preference strength, writing
``train.json`` and the per-category ``score_summary.json``.

Run: ``python -m ospo_tpu_torch.pipeline.step4 --cfg_path configs/step4.yaml
[key=value ...]`` (``device=cpu`` to run on the CPU; ``image_path=null``
runs 4a alone).
"""

from __future__ import annotations

import argparse
import os
import traceback
from glob import glob
from typing import List

from ospo_tpu_torch import chat
from ospo_tpu_torch.config import build_config
from ospo_tpu_torch.engine.scoring import ScoringEngine, compute_preference_strength
from ospo_tpu_torch.engine.text_engine import TextGenEngine
from ospo_tpu_torch.io import (gather_objects, process_index, read_json,
                               save_json, save_json_sharded, set_seed,
                               shard_for_process)
from ospo_tpu_torch.ops.build import KernelError
from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.pipeline.datasets import batched_grouped
from ospo_tpu_torch.pipeline.model_factory import get_model
from ospo_tpu_torch.pipeline.templates import get_vqa_conversation
from ospo_tpu_torch.platform import maybe_init_distributed
from ospo_tpu_torch.utils.png import read_png
from ospo_tpu_torch.utils.prefetch import prefetch_iter
from ospo_tpu_torch.utils.profiling import span

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


# ---------------------------------------------------------------------------
# 4b — scoring and pair selection
# ---------------------------------------------------------------------------


def item_image_jobs(config, sample: dict) -> List[dict]:
    """One item's step-3 PNG tree → per-image scoring jobs."""
    jobs = []
    for kind in ("base", "negative"):
        paths = sorted(glob(os.path.join(
            config.image_path, kind, sample["category"], sample["item_id"],
            "*.png")))
        for img_idx, path in enumerate(paths):
            jobs.append({"item_id": sample["item_id"], "kind": kind,
                         "img_idx": img_idx, "path": path,
                         "category": sample.get("category", "<none>"),
                         "questions": sample["question"]})
    return jobs


def prepare_chunk(engine: ScoringEngine, jobs: List[dict], unit=None) -> dict:
    """Host half of one chunk: PNG decode (a truncated or corrupt file costs
    its image, ``ospo_tpu/pipeline/step4.py:111-156``) and the engine's
    operand preparation.  Runs on the prefetch thread in
    :func:`run_scoring`, overlapping the previous chunk's device work;
    its span belongs to the chunk's ``unit`` span."""
    with span("step4.prepare", parent=unit):
        images, bad = [], set()
        for i, j in enumerate(jobs):
            try:
                images.append(read_png(j["path"]))
            except Exception as e:
                print(f"Error opening {j['path']}: {e}")
                images.append(None)
                bad.add(i)
        if len(bad) < len(jobs):
            filler = next(img for img in images if img is not None)
            images = [img if img is not None else filler for img in images]
        prep, prep_failed = None, False
        if len(bad) < len(jobs) and not engine._shared_oom:
            try:
                prep = engine.prepare_shared_multi(
                    images, [j["questions"] for j in jobs])
            except Exception as e:  # the shared path is doomed for this chunk
                print(f"# chunk preparation failed ({e}); "
                      f"falling back to unshared scoring")
                traceback.print_exc()
                prep_failed = True
        return {"jobs": jobs, "images": images, "bad": bad, "prep": prep,
                "prep_failed": prep_failed}


def score_prepared_chunk(engine: ScoringEngine, chunk: dict) -> List[dict]:
    """Device half: the shared-prefix program on a prepared chunk, per-image
    calls if the batched call fails, so one bad image cannot sink its
    chunk.  A kernel that did not build or launch is no bad image: its
    error propagates."""
    jobs, images, bad = chunk["jobs"], chunk["images"], chunk["bad"]
    if len(bad) == len(jobs):
        return [None] * len(jobs)
    failed = False
    try:
        results = engine.score_images_multi(
            images, [j["questions"] for j in jobs], prep=chunk["prep"],
            share_prefix=not chunk["prep_failed"])
    except KernelError:
        raise
    except Exception as e:
        print(f"# chunk scoring failed ({e}); retrying per image")
        traceback.print_exc()
        failed = True
    # a model group retries when any of its ranks failed (tensor parallel)
    if not mesh_lib.any_model(failed):
        return [None if i in bad else r for i, r in enumerate(results)]
    results = []
    for i, (img, j) in enumerate(zip(images, jobs)):
        if i in bad:
            results.append(None)
            continue
        engine.counts["per_image_retries"] += 1
        score = None
        try:
            score = engine.score_images_multi([img], [j["questions"]])[0]
        except KernelError:
            raise
        except Exception as e:
            print(f"Error scoring {j['path']}: {e}")
        results.append(None if mesh_lib.any_model(score is None) else score)
    return results


def score_jobs(engine: ScoringEngine, jobs: List[dict]) -> List[dict]:
    """Score a chunk of image jobs (possibly spanning items) in one
    shared-prefix program."""
    return score_prepared_chunk(engine, prepare_chunk(engine, jobs))


def _new_category() -> dict:
    return {"images": 0, "scored": 0, "failed": 0}


def run_scoring(config, engine: ScoringEngine, data: List[dict]):
    """Score every item's step-3 images in chunks of ``score_rows`` (jobs
    sorted by question count, so a chunk shares its suffix stack's size;
    the ragged last chunk padded with its last job) and select pairs →
    ``(pairs, per_category_summary)``.  A category with no scored image,
    or a majority of failed images, aborts after writing the summary
    (``score_failure_gate``, default on)."""
    jobs: List[dict] = []
    for sample in data:
        try:  # a malformed record skips its sample, not the stage
            jobs.extend(item_image_jobs(config, sample))
        except Exception as e:
            print(f"Error preparing jobs for "
                  f"{sample.get('item_id', '<no item_id>')}: {e}")
    jobs.sort(key=lambda j: len(j["questions"]))
    rows = int(config.get("score_rows") or 16)
    chunks = [jobs[c0:c0 + rows] for c0 in range(0, len(jobs), rows)]

    def padded(chunk):
        return chunk + [chunk[-1]] * (rows - len(chunk))

    scored: dict = {}
    by_cat: dict = {}
    # one root span a chunk; its preparation on the prefetch thread joins it
    units = [span("step4.chunk", images=len(c)) for c in chunks]
    prepared = prefetch_iter(zip(units, (padded(c) for c in chunks)),
                             lambda uc: prepare_chunk(engine, uc[1], unit=uc[0]))
    for ci, unit in enumerate(units):
        with unit:
            with span("step4.prep_wait"):
                _, pc = next(prepared)
            results = score_prepared_chunk(engine, pc)
        for job, scores in zip(chunks[ci], results):
            cat = by_cat.setdefault(job["category"], _new_category())
            cat["images"] += 1
            if scores is not None:
                cat["scored"] += 1
                scored.setdefault(job["item_id"], {}).setdefault(
                    job["kind"], {})[f"{job['kind']}_{job['img_idx']}"] = {
                        "path": job["path"], **scores}
            else:
                cat["failed"] += 1
        done = min((ci + 1) * rows, len(jobs))
        if ci % 5 == 4 or done == len(jobs):
            print(f"[step4b] {done}/{len(jobs)} images scored")
    prepared.close()

    output = []
    for sample in data:
        try:
            meta = scored.get(sample["item_id"], {})
            base_meta = meta.get("base", {})
            negative_meta = meta.get("negative", {})
            result = compute_preference_strength(base_meta, negative_meta)
            if result is None:
                continue
            chosen, rejected, score_metadata = result
            output.append({
                "item_id": sample["item_id"],
                "category": sample["category"],
                "sub_category": sample["sub_category"],
                "question": sample["question"],
                "prompt": sample["prompt"],
                "chosen": chosen,
                "rejected": rejected,
                "metadata": {
                    "score_metadata": score_metadata,
                    # the reference's key name, typo included
                    "base_meatadata": base_meta,
                    "negative_metadata": negative_meta,
                },
            })
        except Exception as e:  # per-sample fault tolerance
            print(f"Error selecting pair for {sample.get('item_id')}: {e}")
            traceback.print_exc()
    for rec in output:
        cat = by_cat.setdefault(rec["category"], _new_category())
        cat["pairs"] = cat.get("pairs", 0) + 1
    for cat in by_cat.values():
        cat.setdefault("pairs", 0)
    print(f"[step4b] {len(output)} pairs from {len(data)} items; "
          f"per-category: {by_cat}")

    if config.get("score_failure_gate") is not False and by_cat:
        total_images = sum(c["images"] for c in by_cat.values())
        total_failed = sum(c["failed"] for c in by_cat.values())
        blackout = [k for k, c in by_cat.items()
                    if c["images"] and not c["scored"]]
        majority = total_failed * 2 > total_images
        if blackout or majority:
            if mesh_lib.model_rank() == 0:
                save_json(config.save_path, "score_summary", by_cat)
            raise RuntimeError(
                f"step4b scoring gate: "
                f"{'categories with zero scored images: ' + str(blackout) if blackout else ''}"
                f"{' and ' if blackout and majority else ''}"
                f"{f'{total_failed}/{total_images} images failed' if majority else ''}"
                f" — aborting instead of emitting a train set with silent "
                f"category loss (per-category: {by_cat})")
    return output, by_cat


def main(config) -> None:
    set_seed(int(config.seed or 42))
    model, tokenizer, processor = get_model(config)
    vqa_path = os.path.join(config.save_path, "vqa_prompt.json")
    if not os.path.exists(vqa_path):
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
        scored_input = run_question_gen(config, text_engine, data)
        save_json_sharded(config.save_path, "vqa_prompt", scored_input)
        print("(Step 4) Decompositional Question generation completed.")
    else:
        scored_input = shard_for_process(read_json(vqa_path))
    if not config.get("image_path"):
        return
    scorer = ScoringEngine(model, processor,
                           kv_quant=config.get("score_kv_quant") or False)
    pairs, score_summary = run_scoring(config, scorer, scored_input)
    save_json_sharded(config.save_path, "train", pairs)
    # every process's per-category counts, summed on rank 0 (a model
    # group's once)
    merged: dict = {}
    for part in gather_objects(score_summary if mesh_lib.model_rank() == 0
                               else {}):
        for cat, counts in part.items():
            total = merged.setdefault(cat, dict.fromkeys(counts, 0))
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    if process_index() == 0:
        save_json(config.save_path, "score_summary", merged)
    print("(Step 4) Scoring and Train dataset generation completed.")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", type=str, default="configs/step4.yaml")
    args, _ = parser.parse_known_args()
    config = build_config(cfg_path=args.cfg_path)
    maybe_init_distributed(config.get("device"))
    main(config)
