"""The GDN/MoE trunk (``models/qwen3_next.py``, ``ops/gated_delta.py``, the
expert share of ``ops/moe.py``) against the plain reference
``tests/qwen3_next_reference.py``, on the CPU at a tiny seeded size: one
period of 4 layers (three GDN, one gated full attention), width 64, 16
experts top-4 with a gated shared expert, and norm offsets drawn away from
0, so that a scale ``w`` read for ``1 + w`` fails.

The cached path (chunked prefill, then T = 1 steps through both kinds of
state at a host and at a device length) against the reference's full
forward, with a share of 4 of the 16 experts held; a left-padded prompt
against the same prompt unpadded; the chunked delta rule against the
recurrence; the expert shares against the uncut layer; the DeepSeek-V2
path unchanged with every expert held; the image engine and
``run_step3`` on the trunk; the controls that must fail and the refusals.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import qwen3_next_reference as ref
from ospo_tpu_torch.config import Config
from ospo_tpu_torch.engine.image_engine import ImageGenEngine
from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import llama
from ospo_tpu_torch.models import qwen3_next as q3n
from ospo_tpu_torch.models import weights as weights_lib
from ospo_tpu_torch.ops import gated_delta, moe
from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.processing import t2i_prompt

torch.set_num_threads(2)
# the first parallel torch.exp of a process can come out ~1e-4 off in the
# worker thread's share (MKL VML set-up); make that call here
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))

LC = {"model_type": "qwen3_next", "vocab_size": 512, "hidden_size": 64,
      "intermediate_size": 96, "num_hidden_layers": 4, "num_attention_heads": 4,
      "num_key_value_heads": 2, "head_dim": 16, "partial_rotary_factor": 0.25,
      "rope_theta": 10000000, "full_attention_interval": 4,
      "linear_num_key_heads": 2, "linear_num_value_heads": 4,
      "linear_key_head_dim": 16, "linear_value_head_dim": 16,
      "linear_conv_kernel_dim": 4, "num_experts": 16, "moe_intermediate_size": 32,
      "shared_expert_intermediate_size": 32, "num_experts_per_tok": 4,
      "norm_topk_prob": True, "decoder_sparse_step": 1, "mlp_only_layers": [],
      "rms_norm_eps": 1e-6, "max_position_embeddings": 512}
# the share the cells' configuration has: 4 of the 16 experts on this chip
HELD = (4, 4)
LC_SHARE = {**LC, "num_experts": HELD[1],
            "expert_parallel": {"experts": 16, "first_held": HELD[0], "chips": 4}}
PRE = "language_model.model."


def hf_keys(lc: dict):
    """(key, shape, kind) of the trunk's HF state dict, every expert and
    lm_head included."""
    d, H, Hkv, D = (lc["hidden_size"], lc["num_attention_heads"],
                    lc["num_key_value_heads"], lc["head_dim"])
    hk, hv = lc["linear_num_key_heads"], lc["linear_num_value_heads"]
    dk, dv, K = lc["linear_key_head_dim"], lc["linear_value_head_dim"], \
        lc["linear_conv_kernel_dim"]
    fe, E = lc["moe_intermediate_size"], 16
    yield PRE + "embed_tokens.weight", (lc["vocab_size"], d), "normal"
    for i in range(lc["num_hidden_layers"]):
        b = f"{PRE}layers.{i}."
        yield b + "input_layernorm.weight", (d,), "offset"
        yield b + "post_attention_layernorm.weight", (d,), "offset"
        if ref.is_full(lc, i):
            a = b + "self_attn."
            yield a + "q_proj.weight", (2 * H * D, d), "normal"
            yield a + "k_proj.weight", (Hkv * D, d), "normal"
            yield a + "v_proj.weight", (Hkv * D, d), "normal"
            yield a + "o_proj.weight", (d, H * D), "normal"
            yield a + "q_norm.weight", (D,), "offset"
            yield a + "k_norm.weight", (D,), "offset"
        else:
            a = b + "linear_attn."
            yield a + "in_proj_qkvz.weight", (2 * hk * dk + 2 * hv * dv, d), "normal"
            yield a + "in_proj_ba.weight", (2 * hv, d), "normal"
            yield a + "conv1d.weight", (2 * hk * dk + hv * dv, 1, K), "normal"
            yield a + "A_log", (hv,), "a_log"
            yield a + "dt_bias", (hv,), "dt_bias"
            yield a + "norm.weight", (dv,), "scale"
            yield a + "out_proj.weight", (d, hv * dv), "normal"
        m = b + "mlp."
        yield m + "gate.weight", (E, d), "normal"
        for e in range(E):
            for p, shape in (("gate_proj", (fe, d)), ("up_proj", (fe, d)),
                             ("down_proj", (d, fe))):
                yield f"{m}experts.{e}.{p}.weight", shape, "normal"
        fs = lc["shared_expert_intermediate_size"]
        for p, shape in (("gate_proj", (fs, d)), ("up_proj", (fs, d)),
                         ("down_proj", (d, fs))):
            yield f"{m}shared_expert.{p}.weight", shape, "normal"
        yield m + "shared_expert_gate.weight", (1, d), "normal"
    yield PRE + "norm.weight", (d,), "offset"
    yield "language_model.lm_head.weight", (lc["vocab_size"], d), "normal"


def hf_weights(lc: dict, seed: int = 0):
    """Seeded float32 weights: matrices N(0, fan_in^-½), norm offsets 0.1·N
    (so that ``1 + w`` and ``w`` differ), the gated norms' scales near 1,
    ``A_log`` the log of U(1, 16), ``dt_bias`` N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape, kind in hf_keys(lc):
        if kind == "normal":
            w = rng.standard_normal(shape) * int(np.prod(shape[1:])) ** -0.5
        elif kind == "offset":
            w = 0.1 * rng.standard_normal(shape)
        elif kind == "scale":
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        elif kind == "a_log":
            w = np.log(rng.uniform(1, 16, shape))
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
    cfg = q3n.config_from_hf(lc, dtype)
    ck = DictCheckpoint(w)
    params = weights_lib._port_qwen3_next(ck, cfg, quantize, lm_head=True)
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
    cache = q3n.init_kv_cache(cfg, B, S)
    pm = mask[:, :T0]
    h, cache = q3n.forward(params, cfg, emb[:, :T0], pm, llama.positions_from_mask(pm),
                           kv_cache=cache, self_attn=True)
    outs = [h[:, -1]]
    if device_len:
        cache["length"] = torch.tensor([T0], dtype=torch.int32)
    window = torch.cat([pm, torch.ones((B, S - T0), dtype=torch.int32)], -1)
    for t in range(T0, T):
        pos = (pm.sum(-1, keepdim=True) + (t - T0)).to(torch.int32)
        h, cache = q3n.forward(params, cfg, emb[:, t:t + 1], window, pos, kv_cache=cache)
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
    """Prefill (the chunked delta rule, both states and the K/V written),
    then four T = 1 steps (the plain step over the recurrent and conv
    states, the plain GQA read): each pass's last logits equal the
    reference's full forward with the same 4 of 16 experts held.  Float32
    throughout, so the only differences are fp32 rounding in other orders
    (the chunked form's products and triangular solve, the grouped expert
    sums): 2e-4 of the logits' scale.  int8 weights against the
    reference's dequantized int8 rows."""
    params, cfg = port(weights, quantize)
    ids, mask = _batch(1)
    got, cache = _cached_logits(params, cfg, ids, mask, 9, device_len)
    want = _ref_logits(weights, ids, mask, 9, weight_levels=127 if quantize else None)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 2e-4 * scale
    length = cache["length"]
    assert (int(length) if device_len else length) == ids.shape[1]


def test_a_left_padded_prompt_equals_the_unpadded_one(weights):
    """Row 1's prompt left-padded by 3 (conv input 0, β = 0 and g = 0 at the
    pads) gives the logits of the same tokens unpadded, prefill and steps."""
    params, cfg = port(weights)
    ids, mask = _batch(2)
    got, _ = _cached_logits(params, cfg, ids, mask, 9, False)
    alone, _ = _cached_logits(params, cfg, ids[1:2, 3:], mask[1:2, 3:], 6, False)
    assert (got[:, 1] - alone[:, 0]).abs().max() <= 2e-5 * alone.abs().max()


def test_the_chunked_delta_rule_is_the_recurrence():
    """``delta_rule_chunked`` over 11 positions in chunks of 4 (the last
    one padded) from a non-zero state equals the step-by-step recurrence of
    ``decode_plain``'s equations: outputs and the final state."""
    g0 = torch.Generator().manual_seed(3)
    B, T, H, dk, dv = 2, 11, 3, 8, 5
    q = gated_delta._l2(torch.randn((B, T, H, dk), generator=g0)) * dk ** -0.5
    k = gated_delta._l2(torch.randn((B, T, H, dk), generator=g0))
    v = torch.randn((B, T, H, dv), generator=g0)
    g = -torch.rand((B, T, H), generator=g0)
    beta = torch.rand((B, T, H), generator=g0)
    S0 = torch.randn((B, H, dk, dv), generator=g0)
    o, S = gated_delta.delta_rule_chunked(q, k, v, g, beta, S0, chunk=4)
    Sr, outs = S0.clone(), []
    for t in range(T):
        Sr = Sr * g[:, t].exp()[..., None, None]
        u = beta[:, t, :, None] * (v[:, t] - torch.einsum("bhkv,bhk->bhv", Sr, k[:, t]))
        Sr = Sr + k[:, t, :, :, None] * u[:, :, None, :]
        outs.append(torch.einsum("bhkv,bhk->bhv", Sr, q[:, t]))
    torch.testing.assert_close(o, torch.stack(outs, 1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(S, Sr, atol=1e-5, rtol=1e-5)


def test_expert_shares_add_up_to_the_uncut_layer(weights):
    """The four shares of 4 experts each (the program's layer told which it
    holds, routing over all 16): their partial outputs, with the gated
    shared expert every share computes alike counted once, add up to the
    reference's uncut layer; each share's absent slots make no grouped
    row."""
    lc = LC
    pre = f"{PRE}layers.0.mlp."
    h = torch.randn((40, 64), generator=torch.Generator().manual_seed(5))
    total, routed = 0, 0
    for s in range(4):
        params, cfg = port(weights, lc={**LC, "num_experts": 4,
                                        "expert_parallel": {"experts": 16,
                                                            "first_held": 4 * s}})
        mp = q3n._layer(params["moe"], 0)
        counts = torch.zeros(cfg.held + cfg.n_shared, dtype=torch.int32)
        total = total + moe.routed_experts(h, mp["router"], mp["w13"], mp["w2"], 4, counts,
                                           True, 1.0, cfg.n_shared, held=cfg.held_range,
                                           shared_gate=True)
        routed += int(counts[:cfg.held].sum())
        assert int(counts[cfg.held:].sum()) == h.shape[0]
    assert routed == h.shape[0] * lc["num_experts_per_tok"]
    with ref.full_fp32():
        shared = ref.moe(w=weights, lc=lc, pre=pre, h=h, levels=None, dtype=torch.float32,
                         held=(0, 0))
        uncut = ref.moe(weights, lc, pre, h, None, torch.float32)
    torch.testing.assert_close(total - 3 * shared, uncut, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_the_deepseek_layer_is_unchanged_with_every_expert_held(n_shared):
    """A layer told it holds all of its experts, with weight-1 shared
    experts, gives the DeepSeek-V2 path's outputs and counts bit for bit."""
    g0 = torch.Generator().manual_seed(7)
    E, D, Fe = 8, 64, 32
    x = torch.randn((24, D), generator=g0)
    router = torch.randn((E, D), generator=g0) * D ** -0.5
    w13 = torch.randn((E + n_shared, 2 * Fe, D), generator=g0) * D ** -0.5
    w2 = torch.randn((E + n_shared, D, Fe), generator=g0) * Fe ** -0.5
    outs = []
    for held in (None, (0, E)):
        counts = torch.zeros(E + n_shared, dtype=torch.int32)
        outs.append((moe.routed_experts(x, router, w13, w2, 2, counts, n_shared=n_shared,
                                        held=held), counts))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("control", ["w_for_1_plus_w", "bf16_state"])
def test_controls_fail(weights, control):
    """The program held to a reference that reads the zero-centred norms'
    scale ``w`` for ``1 + w``, or rounds the recurrent state to bf16 after
    every position: far outside the 2e-4 the sound comparison keeps."""
    params, cfg = port(weights)
    ids, mask = _batch(1)
    got, _ = _cached_logits(params, cfg, ids, mask, 9, False)
    kw = {"w_for_1_plus_w": {"offset": False},
          "bf16_state": {"state_dtype": torch.bfloat16}}[control]
    want = _ref_logits(weights, ids, mask, 9, **kw)
    assert (got - want).abs().max() > 5 * 2e-4 * want.abs().max()


def test_config_from_checkpoint_reads_the_trunk_and_its_share(tmp_path):
    cfg = {"language_config": LC_SHARE, "torch_dtype": "float32"}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    jc = weights_lib.config_from_checkpoint(str(tmp_path))
    lc = jc.language
    assert q3n.is_hybrid(lc) and jc.n_embed == 64
    assert (lc.experts, lc.held, lc.held_range, lc.n_shared) == (16, 4, HELD, 1)
    assert (lc.n_full, lc.n_gdn, lc.is_full(3), lc.rotary_dim) == (1, 3, True, 4)
    # one row: 4 value heads of a 16 x 16 fp32 state, and 3 conv inputs of
    # 2·2·16 + 4·16 channels in fp32, in each of the 3 GDN layers
    assert lc.state_bytes(1) == 3 * (4 * 16 * 16 * 4 + 3 * 128 * 4)


def test_refuses_what_is_not_ported(weights, monkeypatch):
    params, cfg = port(weights)
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        q3n.config_from_hf({**LC, "rope_scaling": {"type": "yarn"}}, torch.float32)
    with pytest.raises(NotImplementedError, match="T > 1"):
        cache = q3n.init_kv_cache(cfg, 1, 16)
        cache["length"] = 4
        q3n.forward(params, cfg, torch.zeros((1, 2, 64)), torch.ones((1, 16), dtype=torch.int32),
                    torch.zeros((1, 2), dtype=torch.int32), kv_cache=cache)
    with pytest.raises(NotImplementedError, match="int8/int4 cache"):
        q3n.init_kv_cache(cfg, 2, 8, quantized="int8")
    monkeypatch.setattr(mesh_lib, "model_parallel_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="tensor parallel"):
        q3n.forward(params, cfg, torch.zeros((1, 2, 64)), torch.ones((1, 2), dtype=torch.int32),
                    torch.zeros((1, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the image engine and run_step3 on the trunk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def janus_q3n(weights):
    from ospo_tpu_torch.pipeline.model_factory import get_model

    model, _, processor = get_model(Config.from_nested(
        {"model_path": None, "model_preset": "tiny", "device": "cpu"}))
    params, cfg = port(weights, "int8")
    model.params["language_model"] = params
    model.cfg = dataclasses.replace(model.cfg, language=cfg)
    return model, processor


def _engine(janus_q3n, **kw):
    model, proc = janus_q3n
    return ImageGenEngine(model, proc, image_token_num=model.cfg.num_gen_tokens,
                          img_size=model.cfg.gen_image_size,
                          patch_size=model.cfg.vq.downsample_factor, **kw)


PROMPTS = ["A red cube on top of a blue sphere", "Two cats"]


def test_the_engine_serves_the_trunk_and_matches_the_reference(janus_q3n):
    """Forced CFG logits through the engine's loop (eager, and over the
    trunk graph's static buffers as the CPU runs them) against the
    reference's full forward of each row's prompt and image tokens, through
    the generation head; the graph loop equals the eager one bit for bit."""
    model, proc = janus_q3n
    eager = _engine(janus_q3n)
    graph = _engine(janus_q3n)
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


def test_run_step3_records_the_expert_counters(janus_q3n, tmp_path):
    """``run_step3`` on the trunk writes its PNGs and, per group, a span
    ``image.experts`` whose counters add up over the share: the held
    experts' routed rows and the absent slots are every row's top-k of
    every MoE layer and step; the prefill's span carries the states' bytes."""
    from ospo_tpu_torch.pipeline.step3 import run_step3
    from ospo_tpu_torch.utils.profiling import spans
    import time

    model, proc = janus_q3n
    engine = _engine(janus_q3n)
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
    assert pre.attrs["state_bytes"] == lc.state_bytes(4)
    assert pre.attrs["moe_rows"] == 4 * tokens_of(engine, items) * lc.num_experts_per_tok \
        * lc.n_moe


def tokens_of(engine, items):
    """The prompt bucket of a group's prompts."""
    prompts = [t2i_prompt(engine.processor, it["long_prompt"][0]) for it in items]
    return engine.build_cfg_batch(prompts)[0].shape[1]


@pytest.mark.parametrize("kw", [{"kv_quant": "int8"}, {"kv_layout": "bshd"},
                                {"kv_layout": "bhsd"},
                                {"kv_layout": "bshd", "speculative": 4}])
def test_the_engine_refuses_what_the_cache_cannot_hold(janus_q3n, kw):
    with pytest.raises(NotImplementedError, match="GDN/MoE trunk"):
        _engine(janus_q3n, **kw)


@pytest.mark.parametrize("stage", ["step4b", "step5", "text"])
def test_refuses_the_other_stages(janus_q3n, stage):
    model, proc = janus_q3n
    with pytest.raises(NotImplementedError, match="not ported for the GDN/MoE trunk"):
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

# the kernel's head widths (128, two value heads a key head, conv 4) at a
# small depth and width; the expert kernels take D a multiple of 32, F of 16
CARD_LC = {**LC, "linear_key_head_dim": 128,
           "linear_value_head_dim": 128, "moe_intermediate_size": 64,
           "shared_expert_intermediate_size": 64, "num_experts": 8,
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
        pytest.skip("needs a CUDA device (the GDN and expert kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_step_is_replayed_without_a_host_read(cuda):
    """The trunk at the kernel's head widths in bf16 on the card: the engine
    captures the cached step once and replays it; its forced logits equal
    the eager loop's (same kernels, same order) within bf16 rounding, and
    the replay counts one GDN launch a GDN layer and one gate-up launch a
    MoE layer a step."""
    from ospo_tpu_torch.pipeline.model_factory import get_model
    from ospo_tpu_torch.utils.profiling import kernel_launches

    model, _, proc = get_model(Config.from_nested(
        {"model_path": None, "model_preset": "tiny", "device": "cuda"}))
    # a bf16 trunk (A_log, dt_bias and the norms' scales kept in fp32 by the port)
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
    n0 = kernel_launches()
    a2 = graph.forced_cfg_logits(prompts, forced)
    n1 = kernel_launches()
    steps = graph.image_token_num - 1
    assert n1["gdn_decode"] - n0["gdn_decode"] == cfg.n_gdn * steps
    assert n1["moe_gate_up"] - n0["moe_gate_up"] == cfg.n_moe * graph.image_token_num
    b = eager.forced_cfg_logits(prompts, forced)
    assert graph._graph is not None and graph._graph.graph is not None
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_allclose(a, b, atol=3e-2 * np.abs(b).max(), rtol=0)
