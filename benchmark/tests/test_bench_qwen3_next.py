"""The GDN/MoE step-3 cell on the CPU at a tiny Qwen3-Next trunk (one period
of 4 layers, 16 routed experts of which 8 are held, top-4, a gated shared
expert) under the tiny Janus towers: a whole run through
``drivers/step3_gdn_moe.py`` that is correct and reports the readers that
read the program's counters; the reference's controls that fail, and a
program holding its recurrent state in bf16 that fails; the
roofline functions of ``roofline/gated_delta.py``, ``roofline/mfu_hybrid.py``
and ``roofline/w8a16_hybrid.py`` on hand-worked cases; the configuration's
and the new cells' contract."""

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

SEED = 4_294_967_357
NEW3 = "janus-qwen3-next-80b-a3b.step3"
NEW4 = "janus-pro-7b.step4b"

TINY_LC = {"model_type": "qwen3_next", "vocab_size": 512, "hidden_size": 64,
           "intermediate_size": 96, "num_hidden_layers": 4, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 16, "partial_rotary_factor": 0.25,
           "rope_theta": 10000000, "full_attention_interval": 4,
           "linear_num_key_heads": 2, "linear_num_value_heads": 4,
           "linear_key_head_dim": 16, "linear_value_head_dim": 16,
           "linear_conv_kernel_dim": 4, "num_experts": 8,
           "expert_parallel": {"experts": 16, "chips": 2, "first_held": 4},
           "moe_intermediate_size": 32, "shared_expert_intermediate_size": 32,
           "num_experts_per_tok": 4, "norm_topk_prob": True, "decoder_sparse_step": 1,
           "mlp_only_layers": [], "rms_norm_eps": 1e-6, "max_position_embeddings": 512}
NAME = "tiny.step3-gdn-moe"


def _traffic():
    with open(os.path.join(BENCH, "traffic", "step3-groups-gdn-moe.json")) as f:
        t = json.load(f)
    out = tiny.step3_traffic(check_pairs=2,
                             **{k: t[k] for k in ("driver", "kv_quant", "quantize")})
    out["limits"]["gdn_state_rel"] = t["limits"]["gdn_state_rel"]
    return out


def _tree(tmp_path):
    bench_dir = tiny.make_tree(str(tmp_path), {NAME: ("tiny-gdn-moe", _traffic())})
    cfg = copy.deepcopy(tiny.TINY)
    cfg["language_config"] = TINY_LC
    with open(os.path.join(bench_dir, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(str(tmp_path), "BENCHMARK.json")) as f:
        return bench_dir, json.load(f)


def test_the_gdn_moe_cell_runs_and_matches_the_reference(tmp_path):
    bench_dir, bench = _tree(tmp_path)
    torch.manual_seed(0)
    res = run.run_cell(bench, NAME, SEED, 1.0, True, device="cpu", bench_dir=bench_dir)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    m = res["metrics"]
    # the counters' readers report on the CPU; the device-trace ones need a card
    assert m["expert_imbalance.step3"]["value"] >= 1.0
    assert 0 < m["mfu_hybrid.step3"]["value"]
    for name in ("gdn_state_roofline.step3", "gdn_share.step3", "expert_share.step3",
                 "w8a16_hybrid_roofline.step3", "mfu_moe.step3", "mfu.step3"):
        assert name not in m
    assert "decode_step_ms.step3" in m


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


def test_the_controls_fail_and_the_held_top_k_is_counted(tmp_path):
    """int4 weights throughout in the reference, read at the served
    positions of the greedy groups, beyond the logits' limit the sound run
    keeps; the reference's recurrent state rounded to bf16 after every step
    beyond the states' limit.  The driver's held slots a row are the
    program's counters' (8 of 16 experts' worth of a top-4, two in
    expectation)."""
    driver = _driver(tmp_path)
    driver.setup()
    driver.window(1.0)
    work = driver.cell.record.work
    assert work["experts"] == 8 and work["routed_experts"] == 16
    assert 0 < work["top_k"] < 4
    driver.release()
    checks = {c["name"]: c for c in driver.check(control=True)}
    lim = checks["logit_gap"]["limit"]
    assert checks["logit_gap"]["value"] <= lim
    assert checks["control_int4_all_gap"]["value"] > lim
    lim = checks["gdn_state_rel"]["limit"]
    assert 0 < checks["gdn_state_rel"]["value"] <= lim
    assert checks["control_bf16_state_rel"]["value"] > lim
    assert checks["control_png_mean_abs"]["value"] >= 0


def test_a_program_holding_its_state_in_bf16_is_not_correct(tmp_path, monkeypatch):
    """The states' comparison fails a program whose GDN step rounds its
    recurrent state to bf16, the precision below the configuration's."""
    from ospo_tpu_torch.ops import gated_delta

    real = gated_delta.decode

    def bf16_state(qkvz, ba, conv_w, conv_state, state, *rest):
        out = real(qkvz, ba, conv_w, conv_state, state, *rest)
        state.copy_(state.to(torch.bfloat16))
        return out

    monkeypatch.setattr(gated_delta, "decode", bf16_state)
    driver = _driver(tmp_path)
    driver.setup()
    driver.window(1.0)
    driver.release()
    checks = {c["name"]: c for c in driver.check()}
    assert checks["gdn_state_rel"]["value"] > checks["gdn_state_rel"]["limit"]


def test_gated_delta_roofline_hand_counted():
    from roofline import gated_delta, peaks

    # 1 row, 1 key head of width 2, 2 value heads of width 3, conv 4:
    # C = 2·1·2 + 2·3 = 10 channels; state 2·2·3·4 = 48 bytes each way;
    # conv state 3·10·2 = 60 each way; inputs (10 + 6 + 4)·2 = 40; params
    # 10·4·2 + 2·2·4 + 3·4 = 108; output 6·2 = 12; FLOPs 2·10·4 + 7·2·2·3
    assert gated_delta.work(1, 1, 2, 2, 3, 4) == (80 + 84, 96 + 120 + 40 + 108 + 12)
    # the cell's step: 192 rows, 16 key and 32 value heads of 128: the state
    # is 402.7 MB each way, and bounds the launch at ~0.25 ms at 3.35 TB/s
    flops, nbytes = gated_delta.work(192, 16, 32, 128, 128, 4)
    state = 192 * 32 * 128 * 128 * 4
    assert state == 402_653_184 and 2 * state < nbytes < 2 * state * 1.04
    assert peaks.least_time(flops, nbytes) == nbytes / peaks.HBM_BYTES
    assert 0.24e-3 < peaks.least_time(flops, nbytes) < 0.25e-3


def test_w8a16_hybrid_roofline_hand_counted():
    from roofline import peaks, w8a16_hybrid

    # width 4; one key and one value head of 2: in_proj_qkvz 1·(2·2 + 2·2)
    # = 8 rows, in_proj_ba 2, out_proj [4, 2]; one query and one key head
    # of 2: q_proj (query and gate) 4 rows, k_proj and v_proj 2, o_proj [4, 2]
    assert w8a16_hybrid.gdn_matrices(4, 1, 1, 2, 2) == [(8, 4), (2, 4), (4, 2)]
    assert w8a16_hybrid.full_matrices(4, 1, 1, 2) == [(4, 4), (2, 4), (2, 4), (4, 2)]
    # one row: bytes F·D + 4F + 2(D + F) bound each product: GDN 88 + 28 +
    # 36, full 48 + 28 + 28 + 36
    w = _work()
    assert w8a16_hybrid.least_step(w) == pytest.approx((152 + 140) / peaks.HBM_BYTES)
    # the cell's layers: in_proj_qkvz 12288 x 2048, in_proj_ba 64, out_proj
    # 2048 x 4096; q_proj 8192 (16 heads of 256, query and gate), k and v 512
    assert w8a16_hybrid.gdn_matrices(2048, 16, 32, 128, 128) == [
        (12288, 2048), (64, 2048), (2048, 4096)]
    assert w8a16_hybrid.full_matrices(2048, 16, 2, 256) == [
        (8192, 2048), (512, 2048), (512, 2048), (2048, 4096)]


def _work(**kw):
    w = dict(hidden=4, q_heads=1, kv_heads=1, head_dim=2, lin_k_heads=1, lin_v_heads=1,
             lin_k_dim=2, lin_v_dim=2, conv_kernel=2, gdn_layers=1, full_layers=1,
             moe_layers=2, shared_ffn=2, routed_experts=3, experts=2, expert_ffn=2,
             image_vocab=5, kv_bytes=2, state_bytes=4, conv_bytes=2, rows=1, n_img=2)
    w.update(kw)
    return w


def test_mfu_hybrid_hand_counted():
    """A trunk of one GDN and one full layer at width 4 (every count below
    by hand), one row, a prompt of 1 position and one decode step."""
    from roofline import mfu_hybrid, peaks

    w = _work()
    # GDN: C = 2·1·2 + 1·2 = 6; in 4·(6 + 2 + 2) + out 2·4 = 48; full: q 4·2·1·2
    # + k, v 2·4·1·2 + o 1·2·4 = 40; shared 2·3·4·2 = 48 → dense 136; router
    # 2·(3 + 1)·4 = 32; expert 3·4·2 = 24; head 16 + 20 = 36; aligner 32 + 16
    # = 48; mixer 2·6·2 + 7·1·2·2 = 52; state 1·2·2·4 + 1·6·2 = 28; kv 1·2·1·2·2 = 8
    assert mfu_hybrid._dims(w) == (136, 32, 24, 36, 48, 52, 28, 8)
    # counters of the one step: 2 held slots over the 2 layers (held_k = 1),
    # 3 of the 4 (layer, expert) slots touched
    ex = {"steps": 1, "routed_rows": 2, "expert_slots": 4, "idle_experts": 1}
    fixed = 136 + 2 * 32 + 2 * (36 + 48)
    per_row = 136 + 32 + 2 * 1 * 24 + 36 + 48
    attn = 2 * 2 * 1 * 2
    pre = peaks.least_time(2 * per_row + 52 + attn, fixed + 2 * 2 * 24 + 28 + 8)
    step = peaks.least_time(2 * per_row + 52 + attn * 2, fixed + 3 * 24 + 2 * 28 + 2 * 8)
    assert mfu_hybrid.step3_group(w, 1, ex) == pytest.approx(pre + step)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_configuration_states_its_cut():
    """Published widths and full depth; the held experts under ``reduced``,
    the published count and the deployment beside them; the router's 512
    outputs and top-10 kept."""
    conf = {c["name"]: c for c in _bench()["configs"]}["janus-qwen3-next-80b-a3b"]
    assert conf["reduced"] == ["num_experts"]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    lc = cfg["language_config"]
    assert cfg["reduced"] == ["num_experts"] and cfg["num_experts_published"] == 512
    assert cfg["num_experts"] == lc["num_experts"] == 64
    assert lc["expert_parallel"] == {"experts": 512, "chips": 8, "first_held": 0}
    assert "8 H100s" in cfg["deployment"] and "experts 0-63" in cfg["deployment"]
    for key, want in (("num_hidden_layers", 48), ("hidden_size", 2048), ("head_dim", 256),
                      ("num_experts_per_tok", 10), ("moe_intermediate_size", 512),
                      ("linear_num_value_heads", 32), ("linear_key_head_dim", 128),
                      ("vocab_size", 151936), ("full_attention_interval", 4)):
        assert cfg[key] == lc[key] == want, key
    assert {"recurrent_state", "mtp", "weights"} <= set(cfg["assumed"])


def test_the_new_cells_join_the_lists():
    bench = _bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[NEW3]["chips"] == cells[NEW4]["chips"] == 1
    assert cells[NEW3]["traffic"] == "step3-groups-gdn-moe"
    assert (cells[NEW4]["config"], cells[NEW4]["traffic"]) == ("janus-pro-7b", "step4b-score")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert NEW3 in e2e["img_tok_per_s"]["workloads"]
    assert NEW4 in e2e["scored_images_per_s"]["workloads"]
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("pipeline_host_share", "decode_step_ms", "idle", "trunk_host_ms",
                 "sample_host_ms", "vq_decode_ms", "png_wait_share", "graph_step_share",
                 "expert_gemm_roofline", "expert_share", "expert_imbalance",
                 "gdn_state_roofline", "gdn_share", "mfu_hybrid", "w8a16_hybrid_roofline"):
        assert NEW3 in layer[name + ".step3"]["workloads"], name
    for name in ("mfu", "mfu_moe", "decode_attention_roofline", "w8a16_roofline"):
        assert NEW3 not in layer[name + ".step3"]["workloads"], name
    for m in bench["per_layer"]:
        if m["name"].endswith(".step4b"):
            assert NEW4 in m["workloads"], m["name"]
