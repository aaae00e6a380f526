"""The KDA/MLA/MoE step-3 cell and the group-wise int4 step-3 cell on the CPU.

A tiny Kimi Linear trunk (five layers: KDA at 1, 2 and 4, NoPE MLA at 3
and 5, 1-indexed; a dense first layer; 16 sigmoid-routed experts of which 8
are held, top-4, a correction bias and a shared expert) under the tiny
Janus towers: a whole run through ``drivers/step3_kda_mla_moe.py`` that is
correct and reports the readers that read the program's counters; the
reference's controls that fail, and a program holding its recurrent state
in bf16 that fails.  The tiny LLaMA trunk at ``quantize: int4g`` through
``drivers/step3_int4g.py``: correct against the group-wise int4
reference, and a program at per-row int4 that is not.  The roofline
functions of ``roofline/kda.py`` and ``roofline/mfu_kda.py`` on
hand-worked cases; the configuration's and the new cells' contract."""

from __future__ import annotations

import copy
import json
import os
import sys
import tempfile

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [HERE, BENCH, ROOT]

import run  # noqa: E402
import tiny  # noqa: E402

SEED = 4_294_967_371
KIMI = "janus-kimi-linear-48b-a3b.step3"
INT4G = "janus-pro-7b.step3-int4g"

TINY_LC = {"model_type": "kimi_linear", "vocab_size": 512, "hidden_size": 64,
           "intermediate_size": 96, "num_hidden_layers": 5, "num_attention_heads": 4,
           "num_key_value_heads": 4, "head_dim": 18, "kv_lora_rank": 16,
           "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
           "q_lora_rank": None, "mla_use_nope": True, "rope_scaling": None,
           "rope_theta": 10000, "linear_attn_config": {
               "full_attn_layers": [3, 5], "kda_layers": [1, 2, 4], "head_dim": 16,
               "num_heads": 2, "short_conv_kernel_size": 4},
           "first_k_dense_replace": 1, "moe_intermediate_size": 32, "moe_layer_freq": 1,
           "moe_renormalize": True, "moe_router_activation_func": "sigmoid",
           "num_expert_group": 1, "topk_group": 1, "use_grouped_topk": True,
           "num_experts": 8, "expert_parallel": {"experts": 16, "chips": 2, "first_held": 4},
           "num_experts_per_token": 4, "num_shared_experts": 1,
           "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-5, "hidden_act": "silu",
           "model_max_length": 512}
NAME = "tiny.step3-kda-mla-moe"
NAME4 = "tiny.step3-int4g"


def _traffic():
    with open(os.path.join(BENCH, "traffic", "step3-groups-kda-mla-moe.json")) as f:
        t = json.load(f)
    out = tiny.step3_traffic(check_pairs=2,
                             **{k: t[k] for k in ("driver", "kv_quant", "quantize")})
    out["limits"]["kda_state_rel"] = t["limits"]["kda_state_rel"]
    return out


def _traffic4(quantize: str = "int4g"):
    with open(os.path.join(BENCH, "traffic", "step3-groups-int4g.json")) as f:
        t = json.load(f)
    return tiny.step3_traffic(driver=t["driver"], int4_group=t["int4_group"],
                              quantize=quantize)


# a LLaMA trunk wide enough that the program's groups of 128 input columns
# are not whole rows (the tiny configuration's width 64 would make int4g the
# per-row int4)
WIDE_LC = {**tiny.TINY["language_config"], "hidden_size": 256, "intermediate_size": 384}


def _tree(tmp_path, cells):
    bench_dir = tiny.make_tree(str(tmp_path), cells)
    with open(os.path.join(str(tmp_path), "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, lc in (("tiny-kimi", TINY_LC), ("tiny-wide", WIDE_LC)):
        cfg = copy.deepcopy(tiny.TINY)
        cfg["language_config"] = lc
        with open(os.path.join(bench_dir, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": "test", "reduced": [],
                                 "file": f"benchmark/configs/{name}.json", "why": "CPU tests"})
    for w in bench["workloads"]:
        w["config"] = {NAME: "tiny-kimi", NAME4: "tiny-wide"}.get(w["name"], w["config"])
    return bench_dir, bench


def _kimi_tree(tmp_path):
    return _tree(tmp_path, {NAME: ("tiny-kda-mla-moe", _traffic())})


def test_the_kda_cell_runs_and_matches_the_reference(tmp_path):
    bench_dir, bench = _kimi_tree(tmp_path)
    torch.manual_seed(0)
    res = run.run_cell(bench, NAME, SEED, 1.0, True, device="cpu", bench_dir=bench_dir)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    m = res["metrics"]
    # the counters' readers report on the CPU; the device-trace ones need a card
    assert m["expert_imbalance.step3"]["value"] >= 1.0
    assert 0 < m["mfu_kda.step3"]["value"]
    for name in ("kda_state_roofline.step3", "kda_share.step3", "expert_share.step3",
                 "mfu_hybrid.step3", "mfu_moe.step3", "mfu.step3", "gdn_share.step3"):
        assert name not in m
    assert "decode_step_ms.step3" in m


def _driver(bench_dir, bench, name):
    from harness.cell import Cell, Record
    from harness.trace import Tracer

    w, conf = run.cell_spec(bench, name)
    config = run.load_json(os.path.join(os.path.dirname(bench_dir), conf["file"]))
    traffic = run.load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    mod = run.load_module(os.path.join(bench_dir, "drivers", traffic["driver"] + ".py"),
                          "drivers_" + traffic["driver"])
    scratch = tempfile.mkdtemp()
    cell = Cell(name=name, config_name=w["config"], config=config, traffic_name=w["traffic"],
                traffic=traffic, seed=SEED, seconds=1.0, trace=False,
                device=torch.device("cpu"), scratch=scratch,
                record=Record(tracer=Tracer(False, scratch)))
    return mod.Driver(cell)


def test_the_controls_fail_and_the_held_top_k_is_counted(tmp_path):
    """int4 weights throughout in the reference, read at the served
    positions of the greedy groups, beyond the logits' limit the sound run
    keeps; the reference's recurrent state rounded to bf16 after every
    step, and decayed by one scalar a head, beyond the states' limit.  The
    driver's held slots a row are the program's counters' (8 of 16 experts'
    worth of a top-4, two in expectation)."""
    driver = _driver(*_kimi_tree(tmp_path), NAME)
    driver.setup()
    driver.window(1.0)
    work = driver.cell.record.work
    assert work["experts"] == 8 and work["routed_experts"] == 16
    assert (work["kda_layers"], work["mla_layers"], work["dense_layers"]) == (3, 2, 1)
    assert 0 < work["top_k"] < 4
    driver.release()
    checks = {c["name"]: c for c in driver.check(control=True)}
    lim = checks["logit_gap"]["limit"]
    assert checks["logit_gap"]["value"] <= lim
    assert checks["control_int4_all_gap"]["value"] > lim
    # the CPU's plain step is the reference's arithmetic in fp32, so the
    # states may agree exactly; the controls show the comparison reads them
    lim = checks["kda_state_rel"]["limit"]
    assert checks["kda_state_rel"]["value"] <= lim
    assert checks["control_bf16_state_rel"]["value"] > lim
    assert checks["control_scalar_decay_state_rel"]["value"] > lim
    assert checks["control_png_mean_abs"]["value"] >= 0


def test_a_program_holding_its_state_in_bf16_is_not_correct(tmp_path, monkeypatch):
    """The states' comparison fails a program whose KDA step rounds its
    recurrent state to bf16, the precision below the configuration's."""
    from ospo_tpu_torch.ops import gated_delta

    real = gated_delta.kda_decode

    def bf16_state(q, k, v, f, b, og, conv_w, conv_state, state, *rest):
        out = real(q, k, v, f, b, og, conv_w, conv_state, state, *rest)
        state.copy_(state.to(torch.bfloat16))
        return out

    monkeypatch.setattr(gated_delta, "kda_decode", bf16_state)
    driver = _driver(*_kimi_tree(tmp_path), NAME)
    driver.setup()
    driver.window(1.0)
    driver.release()
    checks = {c["name"]: c for c in driver.check()}
    assert checks["kda_state_rel"]["value"] > checks["kda_state_rel"]["limit"]


@pytest.mark.parametrize("quantize", ["int4g", "int4"])
def test_the_int4g_cell_holds_to_its_own_rounding(tmp_path, quantize):
    """The tiny LLaMA trunk at group-wise int4 is correct against the
    reference handed the same group-wise weights, and its control (the
    reference at per-row int4) reads beyond the limit; a program at
    per-row int4 (``quantize: int4``) is not correct against it."""
    bench_dir, bench = _tree(tmp_path, {NAME4: ("tiny-int4g", _traffic4(quantize))})
    driver = _driver(bench_dir, bench, NAME4)
    driver.setup()
    driver.window(1.0)
    work = driver.cell.record.work
    assert work["weight_bytes"] == 0.5 + 4 / 128 and work["int4_group"] == 128
    driver.release()
    checks = {c["name"]: c for c in driver.check(control=True)}
    lim = checks["logit_gap"]["limit"]
    if quantize == "int4":
        assert checks["logit_gap"]["value"] > lim
        return
    assert checks["logit_gap"]["value"] <= lim
    assert checks["png_mean_abs"]["value"] <= checks["png_mean_abs"]["limit"]
    assert checks["control_int4_row_gap"]["value"] > lim


def test_int4_group_rounding_is_the_programs():
    """``reference/int4g.py`` gives the matrix the program's
    ``quantize_matrix_int4_group`` dequantizes to, at a group of 128 and
    clamped to a narrower row."""
    from ospo_tpu_torch.ops import quant
    from reference import int4g

    g0 = torch.Generator().manual_seed(2)
    for shape, group in (((6, 256), 128), ((4, 64), 128)):
        w = (torch.randn(shape, generator=g0) * 0.05).to(torch.bfloat16)
        q = quant.quantize_matrix_int4_group(w, group)
        want = quant.dequantize_matrix_int4_group(q, torch.float32)
        assert torch.equal(int4g.round_int4_group(w, group), want)


def test_kda_roofline_hand_counted():
    from roofline import kda, peaks

    # 1 row, 2 heads of 2, conv 4: C = 3·2·2 = 12 channels; state 2·2·2·4 =
    # 32 bytes each way; conv state 3·12·2 = 72 each way; inputs (12 + 4 + 4
    # + 2)·2 = 44; params 12·4·2 + 2·4 + 4·4 + 2·4 = 128; output 4·2 = 8;
    # FLOPs 2·12·4 + 7·2·2·2
    assert kda.work(1, 2, 2, 2, 4) == (96 + 56, 64 + 144 + 44 + 128 + 8)
    # the cell's step: 192 rows, 32 heads of 128: the state is 402.7 MB each
    # way, the conv state and the inputs 36 MB more, and bound the launch at
    # ~0.25 ms at 3.35 TB/s
    flops, nbytes = kda.work(192, 32, 128, 128, 4)
    state = 192 * 32 * 128 * 128 * 4
    assert state == 402_653_184 and 2 * state < nbytes < 2 * state * 1.05
    assert 0.25e-3 < peaks.least_time(flops, nbytes) < 0.26e-3


def _work(**kw):
    w = dict(hidden=4, kda_heads=1, kda_dim=2, q_heads=1, kv_lora_rank=2, rope_dim=1,
             q_head_dim=3, v_head_dim=2, conv_kernel=2, kda_layers=1, mla_layers=1,
             dense_layers=1, dense_ffn=2, moe_layers=1, shared_ffn=2, routed_experts=3,
             experts=2, expert_ffn=2, image_vocab=5, latent_bytes=2, state_bytes=4,
             conv_bytes=2, rows=1, n_img=2)
    w.update(kw)
    return w


def test_mfu_kda_hand_counted():
    """A trunk of one KDA, one MLA, a dense and a MoE layer at width 4 (every
    count below by hand), one row, a prompt of 1 position and one step."""
    from roofline import mfu_kda, peaks

    w = _work()
    # KDA (width 2): 4·(6 + 4 + 1) + 2·2·2 + 2·4 = 60; MLA: q 4·1·3 + kv_a
    # 4·3 + kv_b 2·1·(2 + 2) + o 1·2·4 = 40; dense 3·4·2 = 24; shared 24 →
    # 148; router 1·3·4 = 12; expert 24; head 16 + 20 = 36; aligner 32 + 16 =
    # 48; mixer 2·6·2 + 7·1·2·2 = 52; state 1·2·2·4 + 1·6·2 = 28; latent
    # 1·3·2 = 6
    assert mfu_kda._dims(w) == (148, 12, 24, 36, 48, 52, 28, 6)
    ex = {"steps": 1, "routed_rows": 1, "expert_slots": 2, "idle_experts": 1}
    fixed = 148 + 2 * 12 + 2 * (36 + 48)
    per_row = 148 + 12 + 1 * 1 * 24 + 36 + 48
    pre = peaks.least_time(2 * per_row + 52 + 2 * 1 * (3 + 2) * 1,
                           fixed + 2 * 24 + 28 + 6)
    step = peaks.least_time(2 * per_row + 52 + 2 * 1 * (2 * 2 + 1) * 2,
                            fixed + 1 * 24 + 2 * 28 + 2 * 6)
    assert mfu_kda.step3_group(w, 1, ex) == pytest.approx(pre + step)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_configuration_states_its_cut():
    """Published widths, all 27 layers and the full vocabulary; the held
    experts under ``reduced``, the published count and the deployment
    beside them; the router's 256 outputs and top-8 kept; the layer lists
    as published."""
    conf = {c["name"]: c for c in _bench()["configs"]}["janus-kimi-linear-48b-a3b"]
    assert conf["reduced"] == ["num_experts"]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    lc = cfg["language_config"]
    assert cfg["reduced"] == ["num_experts"] and cfg["num_experts_published"] == 256
    assert cfg["num_experts"] == lc["num_experts"] == 64
    assert lc["expert_parallel"] == {"experts": 256, "chips": 4, "first_held": 0}
    assert "4 H100s" in cfg["deployment"] and "experts 0-63" in cfg["deployment"]
    for key, want in (("num_hidden_layers", 27), ("hidden_size", 2304),
                      ("num_experts_per_token", 8), ("moe_intermediate_size", 1024),
                      ("intermediate_size", 9216), ("kv_lora_rank", 512),
                      ("vocab_size", 163840), ("routed_scaling_factor", 2.446)):
        assert cfg[key] == lc[key] == want, key
    la = lc["linear_attn_config"]
    assert la["full_attn_layers"] == [4, 8, 12, 16, 20, 24, 27] and len(la["kda_layers"]) == 20
    assert {"recurrent_state", "e_score_correction_bias", "mla_use_nope", "hf_keys",
            "weights"} <= set(cfg["assumed"])


def test_the_new_cells_join_the_lists():
    bench = _bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[KIMI]["chips"] == cells[INT4G]["chips"] == 1
    assert cells[KIMI]["traffic"] == "step3-groups-kda-mla-moe"
    assert (cells[INT4G]["config"], cells[INT4G]["traffic"]) == ("janus-pro-7b",
                                                                 "step3-groups-int4g")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert {KIMI, INT4G} <= set(e2e["img_tok_per_s"]["workloads"])
    layer = {m["name"]: m for m in bench["per_layer"]}
    generic = ("pipeline_host_share", "decode_step_ms", "idle", "trunk_host_ms",
               "sample_host_ms", "vq_decode_ms", "png_wait_share", "graph_step_share",
               "torch_op_share")
    for name in generic + ("expert_gemm_roofline", "expert_share", "expert_imbalance",
                           "kda_state_roofline", "kda_share", "mfu_kda"):
        assert KIMI in layer[name + ".step3"]["workloads"], name
    for name in ("gdn_state_roofline", "gdn_share", "mfu_hybrid", "w8a16_hybrid_roofline",
                 "mfu", "mfu_moe", "decode_attention_roofline", "w8a16_roofline"):
        assert KIMI not in layer[name + ".step3"]["workloads"], name
    for name in generic + ("decode_attention_roofline", "mfu"):
        assert INT4G in layer[name + ".step3"]["workloads"], name
    for name in ("w8a16_roofline", "expert_share", "mfu_kda"):
        assert INT4G not in layer[name + ".step3"]["workloads"], name
