"""The MLA/MoE step-3 cell on the CPU at a tiny DeepSeek-V2 trunk (3 layers,
one dense, 8 experts, top-2, one shared expert) under the tiny Janus
towers: a whole run through ``drivers/step3_mla_moe.py`` that is correct
and reports the MoE readers that read the program's counters; the
reference's controls and planted faults that fail; the grouped expert
GEMM's roofline on hand-counted cases."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import sys
import tempfile

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, BENCH, os.path.dirname(BENCH)]

import run  # noqa: E402
import tiny  # noqa: E402

SEED = 4_294_967_311

TINY_LC = {"model_type": "deepseek_v2", "vocab_size": 512, "hidden_size": 64,
           "intermediate_size": 96, "moe_intermediate_size": 32,
           "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4,
           "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16,
           "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
           "n_shared_experts": 1, "num_experts_per_tok": 2, "first_k_dense_replace": 1,
           "moe_layer_freq": 1, "norm_topk_prob": False, "routed_scaling_factor": 1,
           "scoring_func": "softmax", "topk_method": "greedy", "rope_theta": 10000,
           "rope_scaling": {"type": "yarn", "factor": 40,
                            "original_max_position_embeddings": 4096, "beta_fast": 32,
                            "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
           "rms_norm_eps": 1e-6, "max_position_embeddings": 512}
NAME = "tiny.step3-mla-moe"


def _traffic():
    with open(os.path.join(BENCH, "traffic", "step3-groups-mla-moe.json")) as f:
        t = json.load(f)
    return tiny.step3_traffic(**{k: t[k] for k in ("driver", "kv_quant", "quantize")})


def _tree(tmp_path):
    bench_dir = tiny.make_tree(str(tmp_path), {NAME: ("tiny-mla-moe", _traffic())})
    cfg = copy.deepcopy(tiny.TINY)
    cfg["language_config"] = TINY_LC
    with open(os.path.join(bench_dir, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(str(tmp_path), "BENCHMARK.json")) as f:
        return bench_dir, json.load(f)


def _run(tmp_path, trace=False):
    bench_dir, bench = _tree(tmp_path)
    torch.manual_seed(0)
    return run.run_cell(bench, NAME, SEED, 1.0, trace, device="cpu", bench_dir=bench_dir)


def test_the_mla_moe_cell_runs_and_matches_the_reference(tmp_path):
    res = _run(tmp_path, trace=True)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    m = res["metrics"]
    # the counters' readers report on the CPU; the device-trace ones need a card
    assert m["expert_imbalance.step3"]["value"] >= 1.0
    assert 0 < m["mfu_moe.step3"]["value"]
    assert "expert_share.step3" not in m and "expert_gemm_roofline.step3" not in m
    assert "decode_step_ms.step3" in m and "mfu.step3" not in m


def _driver(tmp_path):
    from harness.cell import Cell, Record
    from harness.trace import Tracer

    bench_dir, bench = _tree(tmp_path)
    w, conf = run.cell_spec(bench, NAME)
    config = run.load_json(os.path.join(os.path.dirname(bench_dir), conf["file"]))
    traffic = run.load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    mod = run.load_module(os.path.join(bench_dir, "drivers", traffic["driver"] + ".py"),
                          "drivers_" + traffic["driver"])
    scratch = tempfile.mkdtemp()
    cell = Cell(name=NAME, config_name=w["config"], config=config, traffic_name=w["traffic"],
                traffic=traffic, seed=SEED, seconds=1.0, trace=False,
                device=torch.device("cpu"), scratch=scratch,
                record=Record(tracer=Tracer(False, scratch)))
    return mod.Driver(cell)


def test_the_controls_fail(tmp_path):
    """int4 routed experts, int4 weights throughout and renormalised top-k
    weights in the reference, read at the served positions of the greedy
    groups: beyond the limit the sound run keeps."""
    driver = _driver(tmp_path)
    driver.setup()
    driver.window(1.0)
    driver.release()
    checks = {c["name"]: c for c in driver.check(control=True)}
    lim = checks["logit_gap"]["limit"]
    assert checks["logit_gap"]["value"] <= lim
    assert checks["control_logit_gap"]["value"] > lim
    assert checks["control_int4_all_gap"]["value"] > lim
    assert checks["control_renorm_gap"]["value"] > lim


@contextlib.contextmanager
def _fault(name):
    from ospo_tpu_torch.models import deepseek_v2
    from ospo_tpu_torch.ops import moe

    if name == "renormalized":
        real = moe.combine_plain

        def combine(y, topw, dtype):
            return real(y, topw / topw.sum(-1, keepdim=True), dtype)

        saved = (moe, "combine_plain", real)
        moe.combine_plain = combine
    else:   # the shared expert dropped
        real = deepseek_v2._moe

        def no_shared(h, mp, counts, cfg):
            E = cfg.n_routed_experts
            routed = {k: ({n: t[:E] for n, t in v.items()} if isinstance(v, dict) else v[:E])
                      for k, v in mp.items() if k in ("w13", "w2")}
            return real(h, {**mp, **routed}, counts[:E],
                        dataclasses.replace(cfg, n_shared_experts=0))

        saved = (deepseek_v2, "_moe", real)
        deepseek_v2._moe = no_shared
    try:
        yield
    finally:
        setattr(*saved)


@pytest.mark.parametrize("fault", ["renormalized", "no_shared"])
def test_a_planted_fault_fails(tmp_path, fault):
    with _fault(fault):
        res = _run(tmp_path)
    assert not res["correct"], res["compared"]


def test_expert_gemm_roofline_hand_counted():
    from roofline import expert_gemm, peaks

    # 1 row through 1 expert, D 4, F 2, 1 expert, tiles of 16:
    # 2·1·3·4·2 = 48 FLOP; weights 3·4·2 + 4·(4 + 4) = 56; activations
    # 2·(4 + 2)·2 = 24; index 2·4·(1 + 2 + 2·(0 + 1)) = 40
    assert expert_gemm.work(1, 1, 4, 2, 1, 16) == (48, 56 + 24 + 40)
    # a decode step of DeepSeek-V2-Lite: 288 rows, 60 experts touched
    flops, nbytes = expert_gemm.work(288, 60, 2048, 1408, 64, 16)
    assert flops == 2 * 288 * 3 * 2048 * 1408
    assert nbytes == (60 * (3 * 2048 * 1408 + 4 * (2 * 1408 + 2048))
                      + 2 * (288 * 2048 + 288 * 1408) * 2 + 2 * 4 * (288 + 65 + 2 * (18 + 64)))
    # bound by the weights' bytes: ~0.155 ms at 3.35 TB/s
    assert peaks.least_time(flops, nbytes) == nbytes / peaks.HBM_BYTES
    assert 0.15e-3 < peaks.least_time(flops, nbytes) < 0.16e-3
    # the same step with its 2 shared experts in the launches: 48 tokens x
    # (6 + 2) slots = 384 rows over 60 + 2 experts of 66, 384 / 16 + 66 tiles
    flops, nbytes = expert_gemm.work(384, 62, 2048, 1408, 66, 16)
    assert flops == 2 * 384 * 3 * 2048 * 1408
    assert nbytes == (62 * (3 * 2048 * 1408 + 4 * (2 * 1408 + 2048))
                      + 2 * (384 * 2048 + 384 * 1408) * 2 + 2 * 4 * (384 + 67 + 2 * (24 + 66)))
