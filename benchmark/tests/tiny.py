"""A tiny Janus configuration and cells for the CPU tests: the published
layout at toy widths, run through the same drivers with the program's plain
paths, written into a copy of the benchmark under a temporary folder."""

from __future__ import annotations

import copy
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

TINY = {
    "source": "tiny test configuration",
    "reduced": [],
    "model_type": "multi_modality",
    "torch_dtype": "float32",
    "language_config": {"hidden_size": 64, "intermediate_size": 128,
                        "max_position_embeddings": 512, "num_attention_heads": 4,
                        "num_hidden_layers": 2, "num_key_value_heads": 4,
                        "vocab_size": 512, "rope_theta": 10000.0, "rms_norm_eps": 1e-6},
    "vision_config": {"params": {"image_size": 16, "model_name": "siglip_large_patch16_384",
                                 "select_layer": -1, "width": 32, "layers": 2, "heads": 2,
                                 "patch_size": 8, "mlp_ratio": 4.0}},
    "aligner_config": {"params": {"depth": 2}},
    "gen_vision_config": {"params": {"image_token_size": 64, "n_embed": 8, "image_size": 16,
                                     "vq": {"codebook_size": 64, "codebook_dim": 8, "base_ch": 32,
                                            "ch_mult": [1, 2], "num_res_blocks": 2,
                                            "z_channels": 32}}},
    "gen_aligner_config": {"params": {"depth": 2}},
    "preprocessor_config": {"image_size": 16, "image_mean": [0.48145466, 0.4578275, 0.40821073],
                            "image_std": [0.26862954, 0.26130258, 0.27577711],
                            "rescale_factor": 1 / 255},
}


RATES = {"step3": ("img_tok_per_s", "tok/s"), "step5": ("train_pairs_per_s", "pairs/s"),
         "step4b": ("scored_images_per_s", "images/s")}


def make_tree(tmp: str, cells: dict) -> str:
    """A copy of the benchmark under ``tmp`` with the tiny configuration and
    ``cells`` ({name: (traffic name, traffic dict)}) added as files and
    entries → the copy's benchmark folder."""
    bench_dir = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(bench_dir, "configs", "tiny.json"), "w") as f:
        json.dump(TINY, f)
    bench["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for name, (traffic_name, traffic) in cells.items():
        with open(os.path.join(bench_dir, "traffic", traffic_name + ".json"), "w") as f:
            json.dump(traffic, f)
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": traffic_name,
                                   "chips": 1, "why": "CPU test"})
        # the new cell reports what the cells of the same driver report
        siblings = set()
        for w in bench["workloads"]:
            if w["name"] == name:
                continue
            with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
                if json.load(f)["driver"] == traffic["driver"]:
                    siblings.add(w["name"])
        for m in bench["end_to_end"] + bench["per_layer"]:
            if siblings & set(m.get("workloads", ())):
                m["workloads"].append(name)
        if not siblings:   # a stage no cell runs yet: its rate, reported here alone
            bench["end_to_end"].insert(0, {
                "name": RATES[traffic["driver"]][0], "unit": RATES[traffic["driver"]][1],
                "better": "higher", "bound": 0.1, "source": "host_clock",
                "workloads": [name]})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench_dir


def step3_traffic(**over) -> dict:
    with open(os.path.join(BENCH, "traffic", "step3-groups.json")) as f:
        t = json.load(f)
    t = copy.deepcopy(t)
    t.update(pairs=3, prompt_tokens=[5, 9, 14, 30], warm_groups=2, trace_steps=[10, 20], host_trace_steps=[30, 33],
             limits={"logit_gap": 1e-3, "png_mean_abs": 0.05})
    t.update(over)
    return t


def step5_traffic(**over) -> dict:
    with open(os.path.join(BENCH, "traffic", "step5-lora.json")) as f:
        t = copy.deepcopy(json.load(f))
    t.update(batch_size=2, image_pool=6, max_updates=64,
             limits={"grad1_leaf_gap": 1e-2, "update_leaf_gap": 1e-2, "grad1_leaf_diff": 1e-2})
    t["trainer"]["lora"]["lora_rank"] = 4
    t["trainer"]["lora"]["lora_alpha"] = 8
    t["trainer"]["experiment"]["attn_impl"] = "xla"
    t.update(over)
    return t


def benchmark_files():
    """Every file of the benchmark in the repository (its tests aside)."""
    out = [os.path.join(ROOT, "BENCHMARK.json")]
    for d, dirs, files in os.walk(BENCH):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        out += [os.path.join(d, f) for f in files]
    return sorted(out)


def step4b_traffic(**over) -> dict:
    with open(os.path.join(BENCH, "traffic", "step4b-score.json")) as f:
        t = copy.deepcopy(json.load(f))
    t.update(items_per_call=3, image_pool=12, score_rows=4, check_images=64,
             question_counts=[2, 3, 4], question_tokens=[4, 9, 15], prompt_tokens=[3, 10],
             limits={"readout_gap": 1e-3})
    t.update(over)
    return t
