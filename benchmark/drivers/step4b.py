"""Step 4b: self-VQA scoring and pair selection through
``pipeline/step4.run_scoring``.

Each call of ``run_scoring`` scores ``items_per_call`` items, each with
three base and three negative 384² images (distinct PNGs of a seeded pool
written under the run's scratch directory, linked into the step-3 tree
layout) and 2–12 yes/no questions, the last the global one; the engine
scores them in chunks of ``score_rows`` images on the shared-prefix path
over an int8 cache, and the call selects each item's pair.  The loop is
closed: a call starts when the last one returned.

The benchmark sees the program through a subclass of its scoring engine
that keeps what each ``score_images_multi`` call returned and times it.
Local questions open with a word of ``openers`` and the global one with
"This", so the questions of a chunk share no first token.  Every call
holds the same sizes (see :meth:`Driver.items`), so a seed changes the
order of the work, not its amount.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from harness.cell import Cell, prompt_text
from harness.images import make_pool
from harness.port import load_model, processor_for
from harness.weights import make_weights
from reference import janus as ref
from reference import png
from reference import understanding as und

PARTS = ("language", "lm_head", "understanding", "generation")
KINDS = ("base", "negative")


def _engine_class():
    from ospo_tpu_torch.engine.scoring import ScoringEngine

    class WatchedScoring(ScoringEngine):
        """The program's scoring engine.  While ``watch`` is set it keeps
        each call's images, questions and scores and its host span; while
        ``tracing`` is set it profiles its first call (CUDA activity) and
        its second (host ops too) and keeps their operand shapes and flash
        launches."""

        def __init__(self, *args, record=None, **kwargs):
            super().__init__(*args, **kwargs)
            self.calls: List[tuple] = []
            self.traced: List[tuple] = []
            self.record = record
            self.watch = self.tracing = False

        def score_images_multi(self, images, questions_per_image, share_prefix=True,
                               prep=None):
            from ospo_tpu_torch.utils.profiling import kernel_launches

            tracer = self.record.tracer
            n = len(self.traced)
            if self.tracing and n < 2:
                tracer.start(host_ops=n == 1)
            launches = kernel_launches()["flash_fwd"]
            t0 = time.perf_counter()
            out = super().score_images_multi(images, questions_per_image,
                                             share_prefix=share_prefix, prep=prep)
            t1 = time.perf_counter()
            if self.tracing and n < 2:
                tracer.stop()
                self.traced.append((_shapes(self, prep), len(images),
                                    kernel_launches()["flash_fwd"] - launches))
            if self.watch:
                self.calls.append((list(questions_per_image), list(images), out,
                                   _shapes(self, prep)))
                self.record.spans.append(("engine", t0, t1))
            return out

    return WatchedScoring


def _shapes(engine, prep):
    if prep is None:
        return None
    ops = prep.operands
    return {"n": int(ops[0].shape[0]), "p_b": int(ops[0].shape[1]),
            "q_b": int(ops[5].shape[0]), "t_b": int(ops[5].shape[2]),
            "c_pre": int(prep.pre[0].shape[1]) if prep.pre else 0,
            "pre_n": int(prep.pre[1].sum()) if prep.pre else 0,
            "budget": int(engine.row_token_budget), "row_tokens": int(prep.row_tokens)}


def _spread(values: List[int], n: int) -> List[int]:
    """``n`` evenly spaced picks of the sorted ``values``, both ends in."""
    v = sorted(values)
    if n == 1:
        return [v[len(v) // 2]]
    return [v[round(i * (len(v) - 1) / (n - 1))] for i in range(n)]


class Driver:
    def __init__(self, cell: Cell):
        self.cell = cell
        self.t = cell.traffic
        self.calls: List[dict] = []

    # ------------------------------------------------------------------
    def _question(self, rng, n_tokens: int) -> str:
        words = prompt_text(rng, max(1, n_tokens - 1))
        return f"{rng.choice(self.t['openers'])} {words}?"

    def items(self, k: int) -> List[dict]:
        """Call ``k``'s items.  Every call holds the same sizes, in an order
        drawn from the seed: ``items_per_call`` question counts, as many
        local-question lengths as those counts need, and as many prompt
        lengths, each an evenly spaced pick (both ends included) of the
        traffic's list; images: six distinct pool indices an item."""
        rng = self.cell.rng(f"call{k}")
        t = self.t
        n = int(t["items_per_call"])
        counts = _spread(t["question_counts"], n)
        locals_ = _spread(t["question_tokens"], sum(c - 1 for c in counts))
        prompts = _spread(t["prompt_tokens"], n)
        for xs in (counts, locals_, prompts):
            rng.shuffle(xs)
        out = []
        for i, n_q in enumerate(counts):
            prompt = prompt_text(rng, prompts[i])
            qs = [self._question(rng, locals_.pop()) for _ in range(n_q - 1)]
            qs.append(f"This image is generated by a prompt: {prompt}. "
                      "Does this image accurately represent the prompt?")
            out.append({"item_id": f"c{k}i{i}", "category": "object",
                        "sub_category": "object", "prompt": prompt, "question": qs,
                        "images": rng.sample(range(len(self.pool)), 6)})
        return out

    def _tree(self, k: int, items: List[dict]) -> str:
        root = os.path.join(self.cell.scratch, "img", f"c{k}")
        for it in items:
            for j, idx in enumerate(it["images"]):
                d = os.path.join(root, KINDS[j // 3], it["category"], it["item_id"])
                os.makedirs(d, exist_ok=True)
                os.symlink(self.pool[idx], os.path.join(d, f"{j % 3:02d}.png"))
        return root

    def _config(self, image_path: str):
        from ospo_tpu_torch.config import Config

        return Config.from_nested({"image_path": image_path,
                                   "score_rows": int(self.t["score_rows"]),
                                   "score_failure_gate": True,
                                   "save_path": os.path.join(self.cell.scratch, "out")})

    def _run(self, k: int, items: List[dict]):
        from ospo_tpu_torch.pipeline.step4 import run_scoring

        return run_scoring(self._config(self._tree(k, items)), self.engine, items)

    # ------------------------------------------------------------------
    def setup(self) -> None:
        cell, t = self.cell, self.t
        weights = make_weights(cell.config, PARTS, cell.seed, cell.device)
        self.model = load_model(cell.config, weights, cell.scratch, cell.device,
                                quantize=t["quantize"], understanding=True, lm_head=True)
        del weights
        self.processor = processor_for(self.model, cell.config)
        side = cell.config["preprocessor_config"]["image_size"]
        pool = make_pool(int(t["image_pool"]), side, cell.seed, cell.device)
        self.pool_keys = {p[::37, ::41].tobytes(): i for i, p in enumerate(pool)}
        pool_dir = os.path.join(cell.scratch, "pool")
        os.makedirs(pool_dir, exist_ok=True)
        self.pool = []
        for i, img in enumerate(pool):
            self.pool.append(os.path.join(pool_dir, f"{i:03d}.png"))
            png.write(self.pool[-1], img)
        self.engine = _engine_class()(self.model, self.processor,
                                      kv_quant=t["score_kv_quant"], record=cell.record)
        # warm-up: one call of the traffic's own kind, from items of its own
        self._run(-1, self.items(-1))
        cell.sync()

    def window(self, seconds: float) -> Dict[str, float]:
        cell, rec = self.cell, self.cell.record
        self.engine.watch = True
        t0 = time.perf_counter()
        t_end = t0
        k = 0
        while t_end - t0 < seconds:
            items = self.items(k)
            pairs, summary = self._run(k, items)
            t_end = time.perf_counter()
            self.calls.append({"k": k, "items": items, "pairs": pairs, "summary": summary})
            k += 1
        rec.window = (t0, t_end)
        self.engine.watch = False
        if cell.trace:   # one more call after the window, profiled
            self.engine.tracing = True
            self._run(k, self.items(k))
            self.engine.tracing = False
        traced = self.engine.traced[0] if self.engine.traced else None
        scored = sum(c["scored"] for call in self.calls for c in call["summary"].values())
        images = sum(c["images"] for call in self.calls for c in call["summary"].values())
        lc = self.model.cfg.language
        vc = self.model.cfg.vision
        rec.counters.update(calls=len(self.calls), images_scored=scored,
                            **{k: v for k, v in self.engine.counts.items()})
        rec.work.update(
            stage="step4b", layers=lc.num_layers, hidden=lc.hidden_size,
            ffn=lc.intermediate_size, heads=lc.num_heads, kv_heads=lc.kv_heads,
            head_dim=lc.dim_head, vocab=lc.vocab_size, vit_width=vc.width,
            vit_layers=vc.depth, vit_mlp=vc.mlp_hidden, vit_heads=vc.heads,
            image_tokens=vc.num_patches, kv_bytes=1, weight_bytes=1,
            chunks=[c[3] for c in self.engine.calls if c[3]],
            traced=traced[0] if traced else None,
            traced_flash=traced[2] if traced else 0,
            images_scored=scored,
            idle_unit_s=rec.window_s / scored if scored else None,
            traced_units=traced[1] if traced else 0)
        return {"scored_images_per_s": scored / rec.window_s, "attempted": images,
                "failed": images - scored}

    def release(self) -> None:
        self.engine_calls = self.engine.calls
        del self.engine, self.model
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def _program_scores(self) -> Dict[tuple, dict]:
        """(item id, kind, index) → the program's scores of that image."""
        by_key = {}
        for call in self.calls:
            for it in call["items"]:
                for j, idx in enumerate(it["images"]):
                    by_key[(tuple(it["question"]), idx)] = (it["item_id"], KINDS[j // 3], j % 3)
        out = {}
        for qs_list, images, results, _ in self.engine_calls:
            for qs, img, res in zip(qs_list, images, results):
                key = by_key.get((tuple(qs), self.pool_keys.get(img[::37, ::41].tobytes())))
                if key is not None and res is not None:
                    out[key] = res
        return out

    def check(self, control: bool = False) -> List[dict]:
        cell, t = self.cell, self.t
        cfg = cell.config
        prog = self._program_scores()
        # pair selection, exact: the program's choice against the published
        # rule applied to the program's own answers
        mismatch = 0
        for call in self.calls:
            chosen = {p["item_id"]: int(os.path.basename(p["chosen"])[:2]) for p in call["pairs"]}
            for it in call["items"]:
                sc = {kind: [None] * 3 for kind in KINDS}
                for (item, kind, j), res in prog.items():
                    if item == it["item_id"]:
                        sc[kind][j] = und.scores([(a["p_yes"], a["p_no"])
                                                  for a in res["answer_metadata"]])
                if und.preference_pair(sc["base"], sc["negative"]) != chosen.get(it["item_id"]):
                    mismatch += 1
        missing = sum(len(call["items"]) * 6 for call in self.calls) - len(prog)
        # readouts of a sample of images, with the one that has most questions
        keys = sorted(prog)
        rng = cell.rng("check")
        longest = max(keys, key=lambda k: len(prog[k]["answer_metadata"]))
        rest = [k for k in keys if k != longest]
        sample = [longest] + rng.sample(rest, min(len(rest), int(t["check_images"]) - 1))
        items = {it["item_id"]: it for call in self.calls for it in call["items"]}
        pool = make_pool(int(t["image_pool"]), cfg["preprocessor_config"]["image_size"],
                         cell.seed, cell.device)
        pc = cfg["preprocessor_config"]
        mean = torch.tensor(pc["image_mean"], device=cell.device)
        std = torch.tensor(pc["image_std"], device=cell.device)
        w = make_weights(cfg, PARTS, cell.seed, cell.device)
        gaps, ctrl = [], []
        with ref.full_fp32():
            for key in sample:
                item, kind, j = key
                it = items[item]
                img = png.read(self.pool[it["images"][KINDS.index(kind) * 3 + j]])
                if not np.array_equal(img, pool[it["images"][KINDS.index(kind) * 3 + j]]):
                    raise RuntimeError("a pool image changed on disk")
                x = torch.as_tensor(img, device=cell.device).float() * pc["rescale_factor"]
                emb = und.siglip(w, cfg, ((x - mean) / std)[None])[0]
                got = torch.tensor([[math.log(a["p_yes"]), math.log(a["p_no"])]
                                    for a in prog[key]["answer_metadata"]], device=cell.device)
                want = und.readouts(w, cfg, emb, it["question"], 127, 127)
                gaps.append(float((got - want).abs().max()))
                if control:
                    low = und.readouts(w, cfg, emb, it["question"], 7, 7)
                    ctrl.append(float((low - want).abs().max()))
        shutil.rmtree(os.path.join(cell.scratch, "img"), ignore_errors=True)
        lim = t["limits"]
        out = [{"name": "readout_gap", "value": max(gaps), "limit": lim["readout_gap"]},
               {"name": "pair_mismatch", "value": mismatch + missing, "limit": 0}]
        if control:
            out.append({"name": "control_readout_gap", "value": max(ctrl)})
        return out
