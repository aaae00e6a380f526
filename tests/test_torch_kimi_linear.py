"""The KDA/MLA/MoE trunk (``models/kimi_linear.py``, the KDA step of
``ops/gated_delta.py``, NoPE MLA through ``models/deepseek_v2.py``, the
sigmoid routing of ``ops/moe.py``) against the plain reference
``tests/kimi_linear_reference.py``, on the CPU at a tiny seeded size: five
layers (KDA at 1, 2 and 4, MLA at 3 and 5, 1-indexed), width 64, a dense
first layer, 16 experts top-4 with a correction bias and a shared expert,
and norm scales drawn away from 1.

The cached path (prefill, then T = 1 steps through the latent cache and the
recurrent states at a host and at a device length) against the reference's
full forward, with a share of 4 of the 16 experts held; a left-padded prompt
against the same prompt unpadded; the KDA step and prefill against the
recurrence; NoPE MLA against the expanded form; the sigmoid routing; the
expert shares against the uncut layer; the weight port's keys; the image
engine and ``run_step3`` on the trunk; the controls that must fail and the
refusals.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

import kimi_linear_reference as ref
from ospo_tpu_torch.config import Config
from ospo_tpu_torch.engine.image_engine import ImageGenEngine
from ospo_tpu_torch.models import deepseek_v2
from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import kimi_linear as kl
from ospo_tpu_torch.models import llama
from ospo_tpu_torch.models import weights as weights_lib
from ospo_tpu_torch.ops import gated_delta, moe
from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.processing import t2i_prompt

torch.set_num_threads(2)
# the first parallel torch.exp of a process can come out ~1e-4 off in the
# worker thread's share (MKL VML set-up); make that call here
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))

LC = {"model_type": "kimi_linear", "vocab_size": 512, "hidden_size": 64,
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
      "num_experts": 16, "num_experts_per_token": 4, "num_shared_experts": 1,
      "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-5, "hidden_act": "silu",
      "model_max_length": 512}
# the share the cells' configuration has: 4 of the 16 experts on this chip
HELD = (4, 4)
LC_SHARE = {**LC, "num_experts": HELD[1],
            "expert_parallel": {"experts": 16, "first_held": HELD[0], "chips": 4}}
PRE = "language_model.model."


def hf_keys(lc: dict):
    """(key, shape, kind) of the trunk's HF state dict, every expert and
    lm_head included."""
    d = lc["hidden_size"]
    la = lc["linear_attn_config"]
    H, D, K = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    Hm, dn, dr = lc["num_attention_heads"], lc["qk_nope_head_dim"], lc["qk_rope_head_dim"]
    R, dv = lc["kv_lora_rank"], lc["v_head_dim"]
    fe, E = lc["moe_intermediate_size"], 16
    yield PRE + "embed_tokens.weight", (lc["vocab_size"], d), "normal"

    def mlp(b, names, width):
        for n, shape in zip(names, ((width, d), (width, d), (d, width))):
            yield f"{b}{n}.weight", shape, "normal"

    for i in range(lc["num_hidden_layers"]):
        b = f"{PRE}layers.{i}."
        a = b + "self_attn."
        yield b + "input_layernorm.weight", (d,), "scale"
        yield b + "post_attention_layernorm.weight", (d,), "scale"
        if ref.is_kda(lc, i):
            for n in "qkv":
                yield a + f"{n}_proj.weight", (H * D, d), "normal"
                yield a + f"{n}_conv1d.weight", (H * D, 1, K), "normal"
            yield a + "f_a_proj.weight", (D, d), "normal"
            yield a + "f_b_proj.weight", (H * D, D), "normal"
            yield a + "g_a_proj.weight", (D, d), "normal"
            yield a + "g_b_proj.weight", (H * D, D), "normal"
            yield a + "b_proj.weight", (H, d), "normal"
            yield a + "A_log", (H,), "a_log"
            yield a + "dt_bias", (H * D,), "dt_bias"
            yield a + "o_norm.weight", (D,), "scale"
            yield a + "o_proj.weight", (d, H * D), "normal"
        else:
            yield a + "q_proj.weight", (Hm * (dn + dr), d), "normal"
            yield a + "kv_a_proj_with_mqa.weight", (R + dr, d), "normal"
            yield a + "kv_a_layernorm.weight", (R,), "scale"
            yield a + "kv_b_proj.weight", (Hm * (dn + dv), R), "normal"
            yield a + "o_proj.weight", (d, Hm * dv), "normal"
        if i < lc["first_k_dense_replace"]:
            yield from mlp(b + "mlp.", ("gate_proj", "up_proj", "down_proj"),
                           lc["intermediate_size"])
            continue
        m = b + "block_sparse_moe."
        yield m + "gate.weight", (E, d), "normal"
        yield m + "gate.e_score_correction_bias", (E,), "bias"
        for e in range(E):
            yield from mlp(f"{m}experts.{e}.", ("w1", "w3", "w2"), fe)
        yield from mlp(m + "shared_experts.", ("gate_proj", "up_proj", "down_proj"),
                       fe * lc["num_shared_experts"])
    yield PRE + "norm.weight", (d,), "scale"
    yield "language_model.lm_head.weight", (lc["vocab_size"], d), "normal"


def hf_weights(lc: dict, seed: int = 0):
    """Seeded float32 weights: matrices N(0, fan_in^-½) (the conv's fan-in
    its width), norm scales 1 + 0.1·N, ``A_log`` the log of U(1, 16),
    ``dt_bias`` N(0, 0.5), the correction bias 0.2·N (so that it moves some
    token's experts)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape, kind in hf_keys(lc):
        if kind == "normal":
            w = rng.standard_normal(shape) * int(np.prod(shape[1:])) ** -0.5
        elif kind == "scale":
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        elif kind == "a_log":
            w = np.log(rng.uniform(1, 16, shape))
        elif kind == "bias":
            w = 0.2 * rng.standard_normal(shape)
        else:
            w = 0.5 * rng.standard_normal(shape)
        out[key] = torch.from_numpy(w.astype(np.float32))
    return out


class DictCheckpoint:
    """The loader's shard reader over a dict."""

    def __init__(self, tensors):
        self.tensors, self.consumed = tensors, set()

    def keys(self):
        return self.tensors.keys()

    def __contains__(self, key):
        return key in self.tensors

    def get(self, key, dtype=None):
        self.consumed.add(key)
        return self.tensors[key].to(dtype=dtype or self.tensors[key].dtype, copy=True)


def port(w, quantize="", lc=LC_SHARE, dtype=torch.float32):
    cfg = kl.config_from_hf(lc, dtype)
    ck = DictCheckpoint(w)
    params = weights_lib._port_kimi_linear(ck, cfg, quantize, lm_head=True)
    jc = janus_lib.JanusConfig(language=cfg)
    skipped = weights_lib.expected_skipped_keys(w.keys(), jc)
    assert ck.consumed == set(w) - skipped, sorted(set(w) - skipped - ck.consumed)[:5]
    return params, cfg


@pytest.fixture(scope="module")
def weights():
    return hf_weights(LC, seed=0)


def _batch(seed: int, B: int = 3, T0: int = 9, steps: int = 4):
    """Token ids [B, T0 + steps] with left padding in two rows."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, LC["vocab_size"], (B, T0 + steps)))
    mask = torch.ones((B, T0 + steps), dtype=torch.int32)
    mask[1, :3] = 0
    mask[2, :5] = 0
    return ids, mask


def _cached_logits(params, cfg, ids, mask, T0, device_len):
    """Prefill T0 positions, then one T = 1 step a further position →
    logits of the last position of each pass [steps + 1, B, V]."""
    B, T = ids.shape
    S = T + 3
    emb = params["embed"][ids]
    cache = kl.init_kv_cache(cfg, B, S)
    pm = mask[:, :T0]
    h, cache = kl.forward(params, cfg, emb[:, :T0], pm, llama.positions_from_mask(pm),
                          kv_cache=cache, self_attn=True)
    outs = [h[:, -1]]
    if device_len:
        cache["length"] = torch.tensor([T0], dtype=torch.int32)
    window = torch.cat([pm, torch.ones((B, S - T0), dtype=torch.int32)], -1)
    for t in range(T0, T):
        pos = (pm.sum(-1, keepdim=True) + (t - T0)).to(torch.int32)
        h, cache = kl.forward(params, cfg, emb[:, t:t + 1], window, pos, kv_cache=cache)
        outs.append(h[:, -1])
    return torch.stack(outs) @ params["lm_head"].T, cache


def _ref_logits(w, ids, mask, T0, **kw):
    """The reference's full forward over every prefix length."""
    emb = w[PRE + "embed_tokens.weight"][ids]
    head = w["language_model.lm_head.weight"].float()
    full_mask = mask.clone()
    full_mask[:, T0:] = 1
    outs = []
    with ref.full_fp32():
        for t in range(T0, ids.shape[1] + 1):
            h = ref.forward(w, LC, emb[:, :t], full_mask[:, :t], dtype=torch.float32,
                            held=HELD, **kw)
            outs.append(h[:, -1] @ head.T)
    return torch.stack(outs)


@pytest.mark.parametrize("quantize", ["", "int8"])
@pytest.mark.parametrize("device_len", [False, True])
def test_cached_path_matches_the_reference(weights, quantize, device_len):
    """Prefill (the KDA step a position at a time, both states and the
    latent rows written), then four T = 1 steps (the plain KDA step over the
    recurrent and conv states, MLA's absorbed read of the latent cache):
    each pass's last logits equal the reference's full forward with the
    same 4 of 16 experts held.  Float32 throughout, so the only differences
    are fp32 rounding in other orders (the absorbed form, the grouped expert
    sums): 2e-4 of the logits' scale.  int8 weights against the reference's
    dequantized int8 rows."""
    params, cfg = port(weights, quantize)
    ids, mask = _batch(1)
    got, cache = _cached_logits(params, cfg, ids, mask, 9, device_len)
    want = _ref_logits(weights, ids, mask, 9, weight_levels=127 if quantize else None)
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    length = cache["length"]
    assert (int(length) if device_len else length) == ids.shape[1]


def test_a_left_padded_prompt_equals_the_unpadded_one(weights):
    """Row 1's prompt left-padded by 3 (conv input 0, β = 0 and g = 0 at the
    pads, no MLA key) gives the logits of the same tokens unpadded, prefill
    and steps."""
    params, cfg = port(weights)
    ids, mask = _batch(2)
    got, _ = _cached_logits(params, cfg, ids, mask, 9, False)
    alone, _ = _cached_logits(params, cfg, ids[1:2, 3:], mask[1:2, 3:], 6, False)
    assert (got[:, 1] - alone[:, 0]).abs().max() <= 2e-5 * alone.abs().max()


def _kda_inputs(seed: int, B=3, T=7, H=2, D=16, K=4):
    g0 = torch.Generator().manual_seed(seed)
    r = lambda *s, std=1.0: torch.randn(s, generator=g0) * std  # noqa: E731
    proj = {n: r(B, T, H * D) for n in ("q", "k", "v", "f", "og")}
    proj["b"] = r(B, T, H)
    lw = {"conv_w": r(3 * H * D, K, std=0.5), "A_log": torch.log(1 + 15 * torch.rand(
        (H,), generator=g0)), "dt_bias": r(H * D, std=0.5), "norm": 1 + r(D, std=0.1)}
    return proj, lw


@pytest.mark.parametrize("control", [None, "scalar_decay"])
def test_the_kda_step_and_prefill_are_the_recurrence(control):
    """``kda_prefill`` over 7 positions (its steps ``kda_decode_plain``), from
    zeroed states, against the reference's recurrence: the final state and
    each position's delta-rule state via ``kda_step``, the outputs through
    the gated norm.  The control (each head decayed by the mean of its g,
    a GDN's arithmetic) is far from it."""
    B, T, H, D, K = 3, 7, 2, 16, 4
    proj, lw = _kda_inputs(11)
    conv = torch.zeros((B, K - 1, 3 * H * D))
    state = torch.zeros((B, H, D, D))
    out = gated_delta.kda_prefill(proj["q"], proj["k"], proj["v"], proj["f"], proj["b"],
                                  proj["og"], None, lw["conv_w"], conv, state,
                                  lw["A_log"], lw["dt_bias"], lw["norm"], H, 1e-5)
    lc = {"linear_attn_config": {"num_heads": H, "head_dim": D}}
    layers = {"conv": lw["conv_w"].T[None, None], "A_log": lw["A_log"].view(1, 1, H, 1),
              "dt_bias": lw["dt_bias"].view(1, 1, H, D)}
    S, win = torch.zeros((1, B, H, D, D)), torch.zeros((1, B, K - 1, 3 * H * D))
    for t in range(T):
        x = torch.cat([proj[n][:, t] for n in "qkv"], -1)[None]
        full = torch.cat([win[0], x[0][:, None]], 1)                  # [B, K, C]
        S, win = ref.kda_step(lc, layers, x, proj["f"][None, :, t], proj["b"][None, :, t],
                              win, S, scalar_decay=control == "scalar_decay")
    dist = (state - S[0]).norm() / S[0].norm()
    if control:
        assert dist > 1e-2
        return
    assert dist <= 1e-5
    torch.testing.assert_close(conv, win[0])
    # the outputs: the last position's o = Sᵀq through the gated norm
    act = torch.nn.functional.silu((full * lw["conv_w"].T).sum(1))
    q = ref.l2norm(act[:, :H * D].view(B, H, D)) * D ** -0.5
    o = (S[0] * q[..., :, None]).sum(-2)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + 1e-5) * lw["norm"] \
        * torch.sigmoid(proj["og"][:, -1].view(B, H, D))
    torch.testing.assert_close(out[:, -1], o.reshape(B, -1), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rope", [False, True])
def test_nope_mla_is_the_expanded_form(weights, rope):
    """Layer 3's MLA (``deepseek_v2.mla`` under ``use_nope``) over a prefill
    and one absorbed step through the latent cache equals the reference's
    expanded form with the rope dims unrotated; the rotated control is far
    from it."""
    params, cfg = port(weights)
    mcfg = cfg.mla
    lp = deepseek_v2._layer(params["mla"], 0)
    g0 = torch.Generator().manual_seed(4)
    B, T = 2, 6
    h = torch.randn((B, T + 1, 64), generator=g0)
    mask = torch.ones((B, T + 1), dtype=torch.int32)
    cache = {"ckv": torch.zeros((1, B, T + 1, mcfg.latent_dim)), "length": 0}
    pre = deepseek_v2.mla(h[:, :T], lp, 0, cache, False, mask[:, :T], None, None, 0, mcfg)
    cache["length"] = T
    bias = deepseek_v2.step_bias(mask, cache, mcfg)
    step = deepseek_v2.mla(h[:, T:], lp, 0, cache, True, mask, None, bias, T, mcfg)
    got = torch.cat([pre, step], 1)
    pos = torch.arange(T + 1)[None].expand(B, T + 1)
    with ref.full_fp32():
        want = ref.mla(weights, LC, f"{PRE}layers.2.self_attn.", h, mask, pos, None,
                       torch.float32, rope=rope)
    err = (got - want).abs().max() / want.abs().max()
    assert (err > 1e-2) if rope else (err <= 2e-5)


def test_sigmoid_routing_takes_the_bias_for_the_choice_only(weights):
    """The router of layer 2: the top-k over sigmoid + correction bias, the
    weights the unbiased sigmoids renormalised over (Σ + 1e-20) times 2.446
    (the reference's route); the bias changes some token's experts, and the
    weights of the experts a token keeps are the same with and without it."""
    params, cfg = port(weights, lc=LC)
    mp = deepseek_v2._layer(params["moe"], 0)
    h = torch.randn((64, 64), generator=torch.Generator().manual_seed(8))
    ids, w = moe.route(h, mp["router"], 4, True, cfg.routed_scaling_factor,
                       score_bias=mp["bias"])
    want_i, want_w = ref.route(weights, LC, f"{PRE}layers.1.block_sparse_moe.", h)
    assert torch.equal(ids.long(), want_i)
    torch.testing.assert_close(w, want_w, atol=1e-6, rtol=1e-6)
    plain_i, plain_w = moe.route(h, mp["router"], 4, True, cfg.routed_scaling_factor,
                                 score_bias=torch.zeros_like(mp["bias"]))
    moved = (ids.sort(1).values != plain_i.sort(1).values).any(1)
    assert 0 < int(moved.sum()) < h.shape[0]
    s = torch.sigmoid(h @ mp["router"].T)
    for got_i, got_w in ((ids, w), (plain_i, plain_w)):
        chosen = s.gather(1, got_i.long())
        torch.testing.assert_close(got_w, chosen / chosen.sum(1, keepdim=True)
                                   * cfg.routed_scaling_factor)
    assert moe.routing_gap(h, mp["router"], ids, w, 4, True, cfg.routed_scaling_factor,
                           mp["bias"])[0] == 0


def test_layer_kinds_come_from_the_one_indexed_lists(tmp_path):
    """``kda_layers`` [1, 2, 4] and ``full_attn_layers`` [3, 5] (1-indexed)
    make layers 0, 1, 3 KDA and 2, 4 MLA, the last layer MLA; the config
    reads the share, the routing and the states' bytes; a layer listed
    twice or not at all raises."""
    (tmp_path / "config.json").write_text(json.dumps(
        {"language_config": LC_SHARE, "torch_dtype": "float32"}))
    jc = weights_lib.config_from_checkpoint(str(tmp_path))
    lc = jc.language
    assert kl.is_kimi(lc) and janus_lib.is_hybrid(lc) and jc.n_embed == 64
    assert [lc.is_kda(i) for i in range(5)] == [True, True, False, True, False]
    assert (lc.n_kda, lc.n_mla, lc.n_moe, lc.n_dense) == (3, 2, 4, 1)
    assert (lc.experts, lc.held, lc.held_range, lc.n_shared) == (16, 4, HELD, 1)
    assert (lc.num_experts_per_tok, lc.norm_topk_prob, lc.routed_scaling_factor) == \
        (4, True, 2.446)
    assert lc.mla.use_nope and lc.mla.softmax_scale == 24 ** -0.5
    # one row: 2 heads of a 16 x 16 fp32 state and 3 conv inputs of 3·2·16
    # channels in fp32, in each of the 3 KDA layers
    assert lc.state_bytes(1) == 3 * (2 * 16 * 16 * 4 + 3 * 96 * 4)
    bad = {**LC, "linear_attn_config": {**LC["linear_attn_config"], "kda_layers": [1, 2, 3]}}
    with pytest.raises(ValueError, match="each of the 5 layers once"):
        kl.config_from_hf(bad, torch.float32)


def test_expert_shares_add_up_to_the_uncut_layer(weights):
    """The four shares of 4 experts each (the program's layer told which it
    holds, routing over all 16 with the correction bias): their partial
    outputs, with the shared expert every share computes alike counted
    once, add up to the reference's uncut layer; each share's absent slots
    make no grouped row."""
    pre = f"{PRE}layers.1.block_sparse_moe."
    h = torch.randn((40, 64), generator=torch.Generator().manual_seed(5))
    total, routed = 0, 0
    for s in range(4):
        params, cfg = port(weights, lc={**LC, "num_experts": 4,
                                        "expert_parallel": {"experts": 16,
                                                            "first_held": 4 * s}})
        mp = deepseek_v2._layer(params["moe"], 0)
        counts = torch.zeros(cfg.held + cfg.n_shared, dtype=torch.int32)
        total = total + kl._moe(h[None], mp, counts, cfg)[0]
        routed += int(counts[:cfg.held].sum())
        assert int(counts[cfg.held:].sum()) == h.shape[0]
    assert routed == h.shape[0] * LC["num_experts_per_token"]
    with ref.full_fp32():
        shared = ref.moe(weights, LC, pre, h, None, torch.float32, held=(0, 0))
        uncut = ref.moe(weights, LC, pre, h, None, torch.float32)
    torch.testing.assert_close(total - 3 * shared, uncut, atol=2e-5, rtol=2e-5)


def test_the_weight_port_reads_every_key_of_its_share(weights):
    """The port reads every key but the experts other chips hold (and skips
    those by name); its tree has the KDA, MLA, dense and MoE stacks with the
    correction bias and the shared expert after the held ones."""
    params, cfg = port(weights, "int8")
    skipped = weights_lib.expected_skipped_keys(
        weights.keys(), janus_lib.JanusConfig(language=cfg))
    assert len(skipped) == 4 * 12 * 3
    assert all(".block_sparse_moe.experts." in k for k in skipped)
    assert params["kda"]["conv_w"].shape == (3, 96, 4)
    assert params["kda"]["dt_bias"].shape == (3, 32) and params["kda"]["A_log"].shape == (3, 2)
    assert params["kda"]["wq"]["q"].dtype == torch.int8
    assert params["mla"]["w_uk"].shape == (2, 4, 16, 16)
    assert params["moe"]["bias"].dtype == torch.float32
    assert params["moe"]["bias"].shape == (4, 16) and params["moe"]["router"].shape == (4, 16, 64)
    assert params["moe"]["w13"]["q"].shape == (4, 5, 64, 64)
    assert set(params["dense"]) == {"w_gate", "w_up", "w_down"}


@pytest.mark.parametrize("control", ["bf16_state", "scalar_decay", "rope"])
def test_controls_fail(weights, control):
    """The program held to a reference that rounds the recurrent state to
    bf16 after every position, decays each head by one scalar (GDN's
    arithmetic under KDA's name), or rotates MLA's rope dims: far outside
    the 2e-4 the sound comparison keeps."""
    params, cfg = port(weights)
    ids, mask = _batch(1)
    got, _ = _cached_logits(params, cfg, ids, mask, 9, False)
    kw = {"bf16_state": {"state_dtype": torch.bfloat16}, "scalar_decay": {"scalar_decay": True},
          "rope": {"rope": True}}[control]
    want = _ref_logits(weights, ids, mask, 9, **kw)
    assert (got - want).abs().max() > 5 * 2e-4 * want.abs().max()


def test_refuses_what_is_not_ported(weights, monkeypatch):
    params, cfg = port(weights)
    for key, val in (("q_lora_rank", 1536), ("mla_use_output_gate", True),
                     ("moe_router_activation_func", "softmax")):
        with pytest.raises(NotImplementedError, match=key):
            kl.config_from_hf({**LC, key: val}, torch.float32)
    with pytest.raises(NotImplementedError, match="T > 1"):
        cache = kl.init_kv_cache(cfg, 1, 16)
        cache["length"] = 4
        kl.forward(params, cfg, torch.zeros((1, 2, 64)), torch.ones((1, 16), dtype=torch.int32),
                   torch.zeros((1, 2), dtype=torch.int32), kv_cache=cache)
    with pytest.raises(NotImplementedError, match="int8/int4 latent cache"):
        kl.init_kv_cache(cfg, 2, 8, quantized="int8")
    with pytest.raises(NotImplementedError, match="int8"):
        port(weights, "int4g")
    monkeypatch.setattr(mesh_lib, "model_parallel_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="tensor parallel"):
        kl.forward(params, cfg, torch.zeros((1, 2, 64)), torch.ones((1, 2), dtype=torch.int32),
                   torch.zeros((1, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the image engine and run_step3 on the trunk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def janus_kimi(weights):
    from ospo_tpu_torch.pipeline.model_factory import get_model

    model, _, processor = get_model(Config.from_nested(
        {"model_path": None, "model_preset": "tiny", "device": "cpu"}))
    params, cfg = port(weights, "int8")
    model.params["language_model"] = params
    model.cfg = dataclasses.replace(model.cfg, language=cfg)
    return model, processor


def _engine(janus_kimi, **kw):
    model, proc = janus_kimi
    return ImageGenEngine(model, proc, image_token_num=model.cfg.num_gen_tokens,
                          img_size=model.cfg.gen_image_size,
                          patch_size=model.cfg.vq.downsample_factor, **kw)


PROMPTS = ["A red cube on top of a blue sphere", "Two cats"]


def test_the_engine_serves_the_trunk_and_matches_the_reference(janus_kimi):
    """Forced CFG logits through the engine's loop (eager, and over the
    trunk graph's static buffers as the CPU runs them) against the
    reference's full forward of each row's prompt and image tokens, through
    the generation head; the graph loop equals the eager one bit for bit."""
    model, proc = janus_kimi
    eager = _engine(janus_kimi)
    graph = _engine(janus_kimi)
    graph._replays_trunk = lambda: True
    n_img = eager.image_token_num
    prompts = [t2i_prompt(proc, p) for p in PROMPTS]
    forced = np.random.default_rng(4).integers(0, model.cfg.image_token_size, (2, n_img))
    got = graph.forced_cfg_logits(prompts, forced)
    assert np.array_equal(got, eager.forced_cfg_logits(prompts, forced))
    assert graph._graph is not None
    tokens, mask = eager.build_cfg_batch(prompts)
    params = model.params
    emb = params["language_model"]["embed"][torch.from_numpy(tokens).long()]
    img = janus_lib.prepare_gen_img_embeds(params, model.cfg,
                                           torch.from_numpy(np.concatenate([forced, forced])))
    x = torch.cat([emb, img[:, :-1]], dim=1)
    full = torch.cat([torch.from_numpy(mask), torch.ones((4, n_img - 1), dtype=torch.int32)], 1)
    w = hf_weights(LC, seed=0)
    with ref.full_fp32():
        h = ref.forward(w, LC, x, full, weight_levels=127, dtype=torch.float32, held=HELD)
    logits = janus_lib.gen_logits(params, h[:, tokens.shape[1] - 1:].to(torch.float32))
    want = (logits[2:] + eager.cfg_weight * (logits[:2] - logits[2:])).numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


def test_run_step3_records_the_expert_counters(janus_kimi, tmp_path):
    """``run_step3`` on the trunk writes its PNGs and, per group, a span
    ``image.experts`` whose counters add up over the share: the held
    experts' routed rows and the absent slots are every row's top-k of
    every MoE layer and step; the prefill's span carries the states' bytes
    and the routed rows."""
    from ospo_tpu_torch.pipeline.step3 import run_step3
    from ospo_tpu_torch.utils.profiling import spans

    model, proc = janus_kimi
    engine = _engine(janus_kimi)
    items = [{"item_id": f"i{i}", "category": "object",
              "long_prompt": [p, "", ""], "negative_long_prompt": ["", "", ""]}
             for i, p in enumerate(PROMPTS)]
    cfg = Config.from_nested({"batch_size": 2, "seed_list": [1, 2, 3],
                              "save_path": str(tmp_path)})
    t0 = time.perf_counter()
    stats = run_step3(cfg, engine, proc, items)
    got = spans(t0, time.perf_counter())
    assert stats["written"] == 2
    assert os.path.exists(tmp_path / "base" / "object" / "i0" / "00.png")
    lc = model.cfg.language
    (ex,) = [s for s in got if s.name == "image.experts"]
    steps = engine.image_token_num - 1
    a = ex.attrs
    assert a["steps"] == steps
    assert a["routed_rows"] + a["absent_slots"] == \
        steps * 4 * lc.num_experts_per_tok * lc.n_moe
    assert 0 < a["absent_slots"] and a["expert_slots"] == steps * lc.n_moe * lc.held
    (pre,) = [s for s in got if s.name == "image.prefill"]
    prompts = [t2i_prompt(proc, it["long_prompt"][0]) for it in items]
    t_prompt = engine.build_cfg_batch(prompts)[0].shape[1]
    assert pre.attrs["state_bytes"] == lc.state_bytes(4)
    assert pre.attrs["moe_rows"] == 4 * t_prompt * lc.num_experts_per_tok * lc.n_moe


@pytest.mark.parametrize("kw", [{"kv_quant": "int8"}, {"kv_layout": "bshd"},
                                {"kv_layout": "bshd", "speculative": 4}])
def test_the_engine_refuses_what_the_cache_cannot_hold(janus_kimi, kw):
    with pytest.raises(NotImplementedError, match="KDA/MLA/MoE trunk"):
        _engine(janus_kimi, **kw)


@pytest.mark.parametrize("stage", ["step4b", "step5", "text"])
def test_refuses_the_other_stages(janus_kimi, stage):
    model, proc = janus_kimi
    with pytest.raises(NotImplementedError, match="not ported for the KDA/MLA/MoE trunk"):
        if stage == "step4b":
            from ospo_tpu_torch.engine.scoring import ScoringEngine
            ScoringEngine(model, proc)
        elif stage == "step5":
            from ospo_tpu_torch.train.trainer import SimPOTrainer
            SimPOTrainer(Config.from_nested({}), model, proc)
        else:
            from ospo_tpu_torch.engine.text_engine import TextGenEngine
            TextGenEngine(model, proc)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# the kernel's head widths (128, heads in pairs, conv 4) at a small depth and
# width; the expert kernels take D a multiple of 32, F of 16
CARD_LC = {**LC, "linear_attn_config": {**LC["linear_attn_config"], "head_dim": 128},
           "moe_intermediate_size": 64, "num_experts": 8,
           "expert_parallel": {"experts": 16, "first_held": 8}}


def _to_device(tree, dev, float_dtype=None):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev, float_dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev, float_dtype) for v in tree]
    if float_dtype is not None and tree.is_floating_point():
        tree = tree.to(float_dtype)
    return tree.to(dev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the KDA and expert kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_step_is_replayed_without_a_host_read(cuda):
    """The trunk at the kernel's head widths in bf16 on the card: the engine
    captures the cached step once and replays it; its forced logits equal
    the eager loop's (same kernels, same order) within bf16 rounding, and
    the replay counts one KDA launch a KDA layer and one gate-up launch a
    MoE layer a step."""
    from ospo_tpu_torch.pipeline.model_factory import get_model
    from ospo_tpu_torch.utils.profiling import kernel_launches

    model, _, proc = get_model(Config.from_nested(
        {"model_path": None, "model_preset": "tiny", "device": "cuda"}))
    params, cfg = port(hf_weights(CARD_LC, seed=1), "int8", CARD_LC, torch.bfloat16)
    model.params["language_model"] = params
    for part in ("gen_aligner", "gen_head", "gen_embed"):   # the VQ model stays fp32
        model.params[part] = _to_device(model.params[part], cuda, torch.bfloat16)
    model.params = _to_device(model.params, cuda)
    model.cfg = dataclasses.replace(model.cfg, language=cfg, dtype=torch.bfloat16)
    mk = lambda: ImageGenEngine(model, proc, image_token_num=model.cfg.num_gen_tokens,  # noqa: E731
                                img_size=model.cfg.gen_image_size,
                                patch_size=model.cfg.vq.downsample_factor)
    graph, eager = mk(), mk()
    eager._replays_trunk = lambda: False
    prompts = [t2i_prompt(proc, p) for p in PROMPTS]
    forced = np.zeros((2, graph.image_token_num), np.int64)
    a = graph.forced_cfg_logits(prompts, forced)
    tokens, _ = graph.build_cfg_batch(prompts)
    n0 = kernel_launches()
    a2 = graph.forced_cfg_logits(prompts, forced)
    n1 = kernel_launches()
    steps = graph.image_token_num - 1
    # the prefill runs the step once a prompt position, the replays once a step
    assert n1["kda_decode"] - n0["kda_decode"] == cfg.n_kda * (steps + tokens.shape[1])
    assert n1["moe_gate_up"] - n0["moe_gate_up"] == cfg.n_moe * graph.image_token_num
    b = eager.forced_cfg_logits(prompts, forced)
    assert graph._graph is not None and graph._graph.graph is not None
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_allclose(a, b, atol=3e-2 * np.abs(b).max(), rtol=0)
