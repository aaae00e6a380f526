"""The MLA/MoE trunk (``models/deepseek_v2.py``, ``ops/moe.py``) against the
plain reference ``tests/deepseek_v2_reference.py``, on the CPU at a tiny
seeded size: 3 layers (one dense), width 64, 4 heads, 8 experts, top-2, one
shared expert, YaRN as published.

The cached path (prefill, then T = 1 steps through the latent cache at a
host and at a device length) against the reference's full forward; the
grouped expert forms against a per-expert loop at decode- and
prefill-sized row counts; int8 experts against the reference's dequantized
rows; YaRN at the published widths; the image engine and ``run_step3`` on
the trunk; the controls that must fail and the refusals.  The captured and
replayed step runs on the card only (``gpu``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import deepseek_v2_reference as ref
from ospo_tpu_torch.config import Config
from ospo_tpu_torch.engine.image_engine import ImageGenEngine
from ospo_tpu_torch.models import deepseek_v2 as dsv2
from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import weights as weights_lib
from ospo_tpu_torch.ops import moe
from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.processing import t2i_prompt
from ospo_tpu_torch.utils.profiling import kernel_launches

torch.set_num_threads(2)
# the first parallel torch.exp of a process can come out ~1e-4 off in the
# worker thread's share (MKL VML set-up); make that call here
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))

LC = {"model_type": "deepseek_v2", "vocab_size": 512, "hidden_size": 64,
      "intermediate_size": 96, "moe_intermediate_size": 32,
      "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4,
      "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16,
      "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
      "n_shared_experts": 1, "num_experts_per_tok": 2, "first_k_dense_replace": 1,
      "moe_layer_freq": 1, "norm_topk_prob": False, "routed_scaling_factor": 1.0,
      "scoring_func": "softmax", "topk_method": "greedy", "rope_theta": 10000.0,
      "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                       "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                       "mscale_all_dim": 0.707},
      "rms_norm_eps": 1e-6, "max_position_embeddings": 512}

PUBLISHED = {**LC, "vocab_size": 102400, "hidden_size": 2048, "intermediate_size": 10944,
             "moe_intermediate_size": 1408, "num_hidden_layers": 27,
             "num_attention_heads": 16, "num_key_value_heads": 16, "kv_lora_rank": 512,
             "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
             "n_routed_experts": 64, "n_shared_experts": 2, "num_experts_per_tok": 6,
             "max_position_embeddings": 163840}


def hf_keys(lc: dict):
    """(key, shape) of the trunk's HF state dict, lm_head included."""
    d, H = lc["hidden_size"], lc["num_attention_heads"]
    dn, dr, dv, R = (lc["qk_nope_head_dim"], lc["qk_rope_head_dim"], lc["v_head_dim"],
                     lc["kv_lora_rank"])
    f, fe, E = lc["intermediate_size"], lc["moe_intermediate_size"], lc["n_routed_experts"]
    pre = "language_model.model."
    yield pre + "embed_tokens.weight", (lc["vocab_size"], d)
    for i in range(lc["num_hidden_layers"]):
        b = f"{pre}layers.{i}."
        yield b + "input_layernorm.weight", (d,)
        yield b + "self_attn.q_proj.weight", (H * (dn + dr), d)
        yield b + "self_attn.kv_a_proj_with_mqa.weight", (R + dr, d)
        yield b + "self_attn.kv_a_layernorm.weight", (R,)
        yield b + "self_attn.kv_b_proj.weight", (H * (dn + dv), R)
        yield b + "self_attn.o_proj.weight", (d, H * dv)
        yield b + "post_attention_layernorm.weight", (d,)
        mlps = [("mlp.", f)] if i < lc["first_k_dense_replace"] else \
            [(f"mlp.experts.{e}.", fe) for e in range(E)] + \
            [("mlp.shared_experts.", fe * lc["n_shared_experts"])]
        if i >= lc["first_k_dense_replace"]:
            yield b + "mlp.gate.weight", (E, d)
        for p, width in mlps:
            yield b + p + "gate_proj.weight", (width, d)
            yield b + p + "up_proj.weight", (width, d)
            yield b + p + "down_proj.weight", (d, width)
    yield pre + "norm.weight", (d,)
    yield "language_model.lm_head.weight", (lc["vocab_size"], d)


def hf_weights(lc: dict, seed: int = 0):
    """Seeded float32 weights: matrices N(0, fan_in^-½), norm scales near
    1 (so that a norm's weight is not the identity)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in hf_keys(lc):
        if len(shape) == 1:
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            w = rng.standard_normal(shape) * shape[-1] ** -0.5
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


def port(w, quantize="", cfg=None):
    cfg = cfg or dsv2.config_from_hf(LC, torch.float32)
    ck = DictCheckpoint(w)
    params = weights_lib._port_deepseek_v2(ck, cfg, quantize, lm_head=True)
    assert ck.consumed == set(w), sorted(set(w) - ck.consumed)[:5]
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
    from ospo_tpu_torch.models import llama

    B, T = ids.shape
    S = T + 3
    emb = params["embed"][ids]
    cache = dsv2.init_kv_cache(cfg, B, S)
    pm = mask[:, :T0]
    h, cache = dsv2.forward(params, cfg, emb[:, :T0], pm, llama.positions_from_mask(pm),
                            kv_cache=cache, self_attn=True)
    outs = [h[:, -1]]
    if device_len:
        cache["length"] = torch.tensor([T0], dtype=torch.int32)
    window = torch.cat([pm, torch.ones((B, S - T0), dtype=torch.int32)], -1)
    for t in range(T0, T):
        pos = (pm.sum(-1, keepdim=True) + (t - T0)).to(torch.int32)
        h, cache = dsv2.forward(params, cfg, emb[:, t:t + 1], window, pos, kv_cache=cache)
        outs.append(h[:, -1])
    return torch.stack(outs) @ params["lm_head"].T, cache


def _ref_logits(w, ids, mask, T0, **kw):
    """The reference's full forward over every prefix length."""
    emb = w["language_model.model.embed_tokens.weight"][ids]
    head = w["language_model.lm_head.weight"].float()
    full_mask = mask.clone()
    full_mask[:, T0:] = 1
    outs = []
    with ref.full_fp32():
        for t in range(T0, ids.shape[1] + 1):
            h = ref.forward(w, LC, emb[:, :t], full_mask[:, :t], dtype=torch.float32, **kw)
            outs.append(h[:, -1] @ head.T)
    return torch.stack(outs)


@pytest.mark.parametrize("quantize", ["", "int8"])
@pytest.mark.parametrize("device_len", [False, True])
def test_cached_path_matches_the_reference(weights, quantize, device_len):
    """Prefill (plain attention, latent cache written), then four T = 1
    steps in the absorbed form: each pass's last logits equal the
    reference's full forward.  Float32 throughout, so the only differences
    are fp32 rounding in other orders (the absorbed products, the grouped
    expert sums): 2e-4 of the logits' scale.  int8 weights against the
    reference's dequantized int8 rows, the same per-row rounding in fp32."""
    params, cfg = port(weights, quantize)
    ids, mask = _batch(1)
    got, cache = _cached_logits(params, cfg, ids, mask, 9, device_len)
    want = _ref_logits(weights, ids, mask, 9, weight_levels=127 if quantize else None)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 2e-4 * scale
    length = cache["length"]
    assert (int(length) if device_len else length) == ids.shape[1]


def test_device_length_steps_equal_host_length_steps(weights):
    """The step a CUDA graph captures (length a tensor, advanced in place;
    the write an ``index_copy_``) equals the host-length step bit for bit,
    the latent cache and the MoE counters too."""
    params, cfg = port(weights, "int8")
    ids, mask = _batch(2)
    a, ca = _cached_logits(params, cfg, ids, mask, 9, False)
    b, cb = _cached_logits(params, cfg, ids, mask, 9, True)
    assert torch.equal(a, b)
    assert torch.equal(ca["ckv"], cb["ckv"])
    assert torch.equal(ca["expert_rows"], cb["expert_rows"])


def test_moe_counters_count_every_routed_row(weights):
    """Row 0 of ``expert_rows`` holds the prefill's routed rows, each T = 1
    step's row its own: tokens × top_k in every MoE layer."""
    params, cfg = port(weights)
    ids, mask = _batch(3)
    _, cache = _cached_logits(params, cfg, ids, mask, 9, True)
    rows = cache["expert_rows"]
    k = cfg.num_experts_per_tok
    assert rows.shape == (ids.shape[1] + 3, cfg.n_moe, cfg.n_routed_experts)
    assert (rows[0].sum(-1) == 3 * 9 * k).all()
    for t in range(9, ids.shape[1]):
        assert (rows[t].sum(-1) == 3 * k).all()
    got = dsv2.expert_counters(rows.numpy(), 9, ids.shape[1] - 9 + 1)
    assert got["routed_rows"] == 4 * 3 * k * cfg.n_moe
    assert got["expert_slots"] == 4 * cfg.n_moe * cfg.n_routed_experts
    assert got["busiest_rows"] >= got["routed_rows"] / cfg.n_routed_experts
    assert 0 <= got["idle_experts"] < got["expert_slots"]


def _experts(seed, E=8, D=64, Fe=32, quantized=True, n_shared=0):
    """A router over E experts and the weights of E + n_shared."""
    g = torch.Generator().manual_seed(seed)
    w13 = torch.randn((E + n_shared, 2 * Fe, D), generator=g) * D ** -0.5
    w2 = torch.randn((E + n_shared, D, Fe), generator=g) * Fe ** -0.5
    router = torch.randn((E, D), generator=g) * D ** -0.5
    if not quantized:
        return router, w13, w2
    from ospo_tpu_torch.ops.quant import quantize_matrix

    return router, quantize_matrix(w13), quantize_matrix(w2)


def experts_loop(x, router, w13, w2, top_k, n_shared=0):
    """The experts written one by one, without grouping or tiles: the
    router's softmax and top-k (then the shared experts at weight 1), each
    expert's SiLU MLP over the tokens that chose it (int8 rows times their
    scales), the weighted sum, all in fp32."""
    E, n = router.shape[0], x.shape[0]
    topw, topi = torch.topk(torch.softmax(x.float() @ router.float().T, -1), top_k, -1)
    topi = torch.cat([topi, torch.arange(E, E + n_shared).expand(n, n_shared)], 1)
    topw = torch.cat([topw, torch.ones(n, n_shared)], 1)

    def mat(w, e):
        return w["q"][e].float() * w["s"][e][:, None] if isinstance(w, dict) else w[e].float()

    out = torch.zeros((n, x.shape[1]))
    for e in range(E + n_shared):
        tok, slot = torch.nonzero(topi == e, as_tuple=True)
        if tok.numel():
            w, xs = mat(w13, e), x[tok].float()
            f = w.shape[0] // 2
            h = torch.nn.functional.silu(xs @ w[:f].T) * (xs @ w[f:].T)
            out.index_add_(0, tok, (h @ mat(w2, e).T) * topw[tok, slot][:, None])
    return out.to(x.dtype)


@pytest.mark.parametrize("n_tok", [24, 512])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_grouped_experts_match_a_per_expert_loop(n_tok, quantized, n_shared):
    """The grouped plain form (route, group, tile table, gate-up with SiLU,
    down, combine) against an expert-by-expert loop, at a decode-sized
    count (24 tokens: 6 rows a routed expert, tiles of 16) and a
    prefill-sized one (512: 128 an expert, tiles of 64), with and without a
    shared expert that every token takes; every grouped row is in one
    tile, each expert's rows contiguous.  Same fp32 products per row, so
    equal to fp32 rounding (1e-5)."""
    router, w13, w2 = _experts(n_tok, quantized=quantized, n_shared=n_shared)
    x = torch.randn((n_tok, 64), generator=torch.Generator().manual_seed(7))
    experts, slots = 8 + n_shared, 2 + n_shared
    counts = torch.zeros(experts, dtype=torch.int32)
    got = moe.routed_experts(x, router, w13, w2, 2, counts, n_shared=n_shared)
    want = experts_loop(x, router, w13, w2, 2, n_shared=n_shared)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert int(counts.sum()) == slots * n_tok
    assert (counts[8:] == n_tok).all()
    topi, _ = moe.with_shared(*moe.route_plain(x, router, 2), 8, n_shared)
    bm = moe.block_m(slots * n_tok, experts)
    assert bm == (16 if n_tok == 24 else 64)
    c, offsets, src, tile_e, tile_s = moe.align_plain(topi, experts, bm)
    assert torch.equal(c, counts)
    covered = torch.zeros(slots * n_tok, dtype=torch.int32)
    for e, r0, r1 in moe._tiles(offsets, tile_e, tile_s, experts, bm):
        assert int(offsets[e]) <= r0 < r1 <= int(offsets[e + 1])
        assert (topi.reshape(-1)[src[r0:r1].long()] == e).all()
        covered[r0:r1] += 1
    assert (covered == 1).all()
    assert tile_e.numel() == moe.max_tiles(slots * n_tok, experts, bm)


@pytest.mark.parametrize("norm_topk", [False, True])
def test_routing_gap_reads_what_departs_from_the_plain_routing(norm_topk):
    """``routing_gap``, which the card's checks hold the routing kernel to:
    ``route_plain``'s own routing departs by nothing; one token whose last
    chosen expert is swapped for the next best counts once, short by the
    difference of their scores (exact: both read from the same fp32
    softmax); a weight off by 0.01 shows as 0.01 (to fp32 rounding)."""
    router, _, _ = _experts(11, quantized=False)
    x = torch.randn((24, 64), generator=torch.Generator().manual_seed(12))
    topi, topw = moe.with_shared(*moe.route_plain(x, router, 2, norm_topk), 8, 1)
    assert moe.routing_gap(x, router, topi, topw, 2, norm_topk) == (0, 0.0, 0.0)
    scores = torch.softmax(x.float() @ router.float().T, dim=-1)
    order = scores[0].argsort(descending=True)
    swapped = topi.clone()
    swapped[0, 1] = order[2]
    differ, short, _ = moe.routing_gap(x, router, swapped, topw, 2, norm_topk)
    assert differ == 1 and short == float(scores[0, order[1]] - scores[0, order[2]]) > 0
    off = topw.clone()
    off[3, 1] += 0.01
    assert moe.routing_gap(x, router, topi, off, 2, norm_topk)[2] == \
        pytest.approx(0.01, rel=1e-4)


def test_the_shared_mlp_cut_into_experts_is_the_mlp(weights):
    """The loader's shared experts (the shared MLP cut into experts of
    width F, int8 down rows quantized whole) give the shared MLP of the
    same int8 rows: the sum of the parts' down products is the whole
    one's (fp32 rounding)."""
    params, cfg = port(weights, "int8")
    pre = "language_model.model.layers.1.mlp.shared_experts."
    from ospo_tpu_torch.ops.quant import quantize_matrix

    whole = {n: quantize_matrix(weights[pre + f"{n}_proj.weight"])
             for n in ("gate", "up", "down")}
    x = torch.randn((5, 64), generator=torch.Generator().manual_seed(2))

    def w8(h, q):
        return (h @ q["q"].float().T) * q["s"]

    want = w8(torch.nn.functional.silu(w8(x, whole["gate"])) * w8(x, whole["up"]),
              whole["down"])
    E = cfg.n_routed_experts
    w13 = {n: t[0, E:] for n, t in params["moe"]["w13"].items()}
    w2 = {n: t[0, E:] for n, t in params["moe"]["w2"].items()}
    got = sum(w8(torch.nn.functional.silu(w8(x, {n: t[j, :32] for n, t in w13.items()}))
                 * w8(x, {n: t[j, 32:] for n, t in w13.items()}),
                 {n: t[j] for n, t in w2.items()}) for j in range(cfg.n_shared_experts))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_int8_experts_match_the_dequantized_rows():
    """int8 experts (payload and fp32 row scales) against the same loop
    over the float32 rows they stand for (the reference's
    ``quantize_rows``): equal to fp32 rounding."""
    router, w13, w2 = _experts(3, quantized=False)
    x = torch.randn((40, 64), generator=torch.Generator().manual_seed(8))
    _, q13, q2 = _experts(3)
    got = moe.routed_experts(x, router, q13, q2, 2, torch.zeros(8, dtype=torch.int32))
    deq13 = torch.stack([ref.quantize_rows(w, 127) for w in w13])
    deq2 = torch.stack([ref.quantize_rows(w, 127) for w in w2])
    want = experts_loop(x, router, deq13, deq2, 2)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    full = experts_loop(x, router, w13, w2, 2)
    assert (got - full).abs().max() > 1e-5      # the quantization shows


def test_yarn_at_the_published_widths():
    """DeepSeek-V2-Lite's rope: correction dims 10..23, softmax scale
    192^-½ · mscale(40, 0.707)² = 0.114721, cos/sin factor 1; the port's
    tables against the reference's frequencies in float64.  The port's
    angles are fp32 products (relative error 2^-24 of the angle): 1e-3 up
    to position 4096, 2e-5 below 200."""
    cfg = dsv2.config_from_hf(PUBLISHED, torch.bfloat16)
    assert cfg == dataclasses.replace(dsv2.DEEPSEEK_V2_LITE, max_seq_len=163840)
    assert dsv2.yarn_correction_range(cfg) == (10, 23)
    assert abs(cfg.softmax_scale - 0.114721) < 5e-7
    inv, cs, scale, rng = ref.yarn(PUBLISHED)
    assert rng == (10, 23) and cs == 1.0 and abs(scale - cfg.softmax_scale) < 1e-9
    pos = torch.arange(0, 4096, 97)[None]
    cos, sin = dsv2.rope_cos_sin(cfg, pos)
    ang = pos.double()[..., None] * inv.double()
    torch.testing.assert_close(cos.double(), torch.cos(ang), atol=1e-3, rtol=0)
    torch.testing.assert_close(sin.double(), torch.sin(ang), atol=1e-3, rtol=0)
    small = pos[:, :3]
    c3, _ = dsv2.rope_cos_sin(cfg, small)
    torch.testing.assert_close(c3.double(), torch.cos(small.double()[..., None] * inv.double()),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("control", ["no_shared", "renormalized", "rotate_half"])
def test_controls_fail(weights, control):
    """The program held to a reference that drops the shared expert,
    renormalises the top-k weights or rotates halves in place of
    interleaved pairs: far outside the 2e-4 the sound comparison keeps."""
    params, cfg = port(weights)
    ids, mask = _batch(1)
    got, _ = _cached_logits(params, cfg, ids, mask, 9, False)
    kw = {"no_shared": {"shared": False}, "renormalized": {"norm_topk": True},
          "rotate_half": {"rope_kind": "half"}}[control]
    want = _ref_logits(weights, ids, mask, 9, **kw)
    assert (got - want).abs().max() > 50 * 2e-4 * want.abs().max()


# ---------------------------------------------------------------------------
# the image engine and run_step3 on the trunk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def janus_mla(weights):
    from ospo_tpu_torch.pipeline.model_factory import get_model

    model, _, processor = get_model(Config.from_nested(
        {"model_path": None, "model_preset": "tiny", "device": "cpu"}))
    params, cfg = port(weights, "int8")
    model.params["language_model"] = params
    model.cfg = dataclasses.replace(model.cfg, language=cfg)
    return model, processor


def _engine(janus_mla, **kw):
    model, proc = janus_mla
    return ImageGenEngine(model, proc, image_token_num=model.cfg.num_gen_tokens,
                          img_size=model.cfg.gen_image_size,
                          patch_size=model.cfg.vq.downsample_factor, **kw)


PROMPTS = ["A red cube on top of a blue sphere", "Two cats"]


def test_the_engine_serves_the_trunk_and_matches_the_reference(janus_mla):
    """Forced CFG logits through the engine's loop (eager, and over the
    trunk graph's static buffers as the CPU runs them) against the
    reference's full forward of each row's prompt and image tokens, through
    the generation head; the graph loop equals the eager one bit for bit."""
    model, proc = janus_mla
    eager = _engine(janus_mla)
    graph = _engine(janus_mla)
    graph._replays_trunk = lambda: True
    n_img = eager.image_token_num
    prompts = [t2i_prompt(proc, p) for p in PROMPTS]
    forced = np.random.default_rng(4).integers(0, model.cfg.image_token_size, (2, n_img))
    got = graph.forced_cfg_logits(prompts, forced)
    assert np.array_equal(got, eager.forced_cfg_logits(prompts, forced))
    assert graph._graph is not None
    # the reference: embeds of [prompt ‖ forced[:-1]] a row, cond and uncond
    tokens, mask = eager.build_cfg_batch(prompts)
    params = model.params
    emb = params["language_model"]["embed"][torch.from_numpy(tokens).long()]
    img = janus_lib.prepare_gen_img_embeds(params, model.cfg,
                                           torch.from_numpy(np.concatenate([forced, forced])))
    x = torch.cat([emb, img[:, :-1]], dim=1)
    full = torch.cat([torch.from_numpy(mask), torch.ones((4, n_img - 1), dtype=torch.int32)], 1)
    w = hf_weights(LC, seed=0)
    with ref.full_fp32():
        h = ref.forward(w, LC, x, full, weight_levels=127, dtype=torch.float32)
    logits = janus_lib.gen_logits(params, h[:, tokens.shape[1] - 1:].to(torch.float32))
    want = (logits[2:] + eager.cfg_weight * (logits[:2] - logits[2:])).numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


def test_run_step3_records_the_expert_counters(janus_mla, tmp_path):
    """``run_step3`` on the trunk writes its PNGs and, per group, a span
    ``image.experts`` whose counters add up: routed rows = steps × rows ×
    top_k × MoE layers; the prefill's span carries its routed rows."""
    from ospo_tpu_torch.pipeline.step3 import run_step3
    from ospo_tpu_torch.utils.profiling import spans
    import time

    model, proc = janus_mla
    engine = _engine(janus_mla)
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
    assert a["routed_rows"] == steps * 4 * lc.num_experts_per_tok * lc.n_moe
    assert a["expert_slots"] == steps * lc.n_moe * lc.n_routed_experts
    assert a["busiest_rows"] * lc.n_routed_experts >= a["routed_rows"]
    (pre,) = [s for s in got if s.name == "image.prefill"]
    assert pre.attrs["moe_rows"] == a["prefill_routed_rows"]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_refuses_a_low_rank_query():
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        dsv2.config_from_hf({**LC, "q_lora_rank": 1536}, torch.float32)


def test_config_from_checkpoint_reads_the_trunk(tmp_path):
    cfg = {"language_config": LC, "torch_dtype": "float32"}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    jc = weights_lib.config_from_checkpoint(str(tmp_path))
    assert dsv2.is_mla(jc.language) and jc.n_embed == 64
    assert jc.language == dsv2.config_from_hf(LC, torch.float32)


def test_refuses_tensor_parallel(weights, monkeypatch):
    params, cfg = port(weights)
    monkeypatch.setattr(mesh_lib, "model_parallel_size", lambda: 2)
    x = torch.zeros((1, 2, 64))
    with pytest.raises(NotImplementedError, match="tensor parallel"):
        dsv2.forward(params, cfg, x, torch.ones((1, 2), dtype=torch.int32),
                     torch.zeros((1, 2), dtype=torch.int32))


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_refuses_a_quantized_latent_cache(janus_mla, kv_quant):
    with pytest.raises(NotImplementedError, match="latent cache"):
        _engine(janus_mla, kv_quant=kv_quant)
    with pytest.raises(NotImplementedError, match="latent cache"):
        dsv2.init_kv_cache(janus_mla[0].cfg.language, 2, 8, quantized=kv_quant)


@pytest.mark.parametrize("stage", ["step4b", "step5", "text"])
def test_refuses_the_other_stages(janus_mla, stage):
    model, proc = janus_mla
    with pytest.raises(NotImplementedError, match="not ported for the MLA/MoE trunk"):
        if stage == "step4b":
            from ospo_tpu_torch.engine.scoring import ScoringEngine
            ScoringEngine(model, proc)
        elif stage == "step5":
            from ospo_tpu_torch.train.trainer import SimPOTrainer
            SimPOTrainer(Config.from_nested({}), model, proc)
        else:
            from ospo_tpu_torch.engine.text_engine import TextGenEngine
            TextGenEngine(model, proc)


def test_refuses_a_cached_step_of_several_positions(weights):
    params, cfg = port(weights)
    cache = dsv2.init_kv_cache(cfg, 1, 16)
    cache["length"] = 4
    with pytest.raises(NotImplementedError, match="T > 1"):
        dsv2.forward(params, cfg, torch.zeros((1, 2, 64)),
                     torch.ones((1, 16), dtype=torch.int32),
                     torch.zeros((1, 2), dtype=torch.int32), kv_cache=cache)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the expert kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_tok", [48, 6144])
def test_expert_kernels_match_the_plain_version(cuda, n_tok):
    """The expert kernels against the plain version at DeepSeek-V2-Lite's
    widths (64 routed experts, top-6, 2 shared, D 2048, F 1408), a decode
    step's 48 rows and a prefill's 6144.  Routing: the experts of
    ``route_plain`` but where a token's k-th and next scores tie to fp32
    rounding (logits summed in another order: a chosen expert's score at
    most 1e-6 below the plain k-th, at most 1 token in 500 differing),
    weights within 1e-5.  Grouping and GEMMs: with the kernels' own routing
    handed to the plain version, the same counts, outputs within bf16
    rounding of each stage (2^-7 relative plus 1e-2 of the scale: products
    summed in fp32 in another order)."""
    E, D, Fe, k, S = 64, 2048, 1408, 6, 2
    router, w13, w2 = _experts(5, E, D, Fe, n_shared=S)
    router = router.to(cuda, torch.bfloat16)
    w13 = {n: t.to(cuda) for n, t in w13.items()}
    w2 = {n: t.to(cuda) for n, t in w2.items()}
    x = torch.randn((n_tok, D), generator=torch.Generator().manual_seed(9)).to(
        cuda, torch.bfloat16)
    counts = torch.zeros(E + S, dtype=torch.int32, device=cuda)
    n0 = kernel_launches()["moe_gate_up"]
    got = moe.routed_experts(x, router, w13, w2, k, counts, n_shared=S)
    assert kernel_launches()["moe_gate_up"] == n0 + 1
    topi, topw = moe.route(x, router, k, n_shared=S)
    differ, shortfall, w_err = moe.routing_gap(x, router, topi, topw, k)
    assert differ <= n_tok // 500 and shortfall <= 1e-6 and w_err <= 1e-5
    bm = moe.block_m(topi.numel(), E + S)
    c, offsets, src, te, ts = moe.align_plain(topi, E + S, bm)
    assert torch.equal(counts, c)
    h = moe.gate_up_plain(x, src, offsets, te, ts, w13, k + S, bm)
    want = moe.combine_plain(moe.down_plain(h, src, offsets, te, ts, w2, bm), topw,
                             x.dtype).float()
    err = (got.float() - want).abs()
    assert (err <= 2 ** -7 * want.abs() + 1e-2 * want.abs().max()).all()


@pytest.mark.gpu
def test_the_step_is_replayed_without_a_host_read(cuda, weights):
    """The tiny trunk in bf16 on the card: the engine captures the cached
    step once and replays it; its forced logits equal the eager loop's
    (same kernels, same order) within bf16 rounding, and the replay
    counts one gate-up launch a MoE layer a step."""
    from ospo_tpu_torch.pipeline.model_factory import get_model

    model, _, proc = get_model(Config.from_nested(
        {"model_path": None, "model_preset": "tiny", "device": "cuda"}))
    params, cfg = port(weights, "int8", dsv2.config_from_hf(LC, torch.bfloat16))
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
    n0 = kernel_launches()["moe_gate_up"]
    a2 = graph.forced_cfg_logits(prompts, forced)
    assert kernel_launches()["moe_gate_up"] - n0 == cfg.n_moe * graph.image_token_num
    b = eager.forced_cfg_logits(prompts, forced)
    assert graph._graph is not None and graph._graph.graph is not None
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_allclose(a, b, atol=3e-2 * np.abs(b).max(), rtol=0)


def _to_device(tree, dev, float_dtype=None):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev, float_dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev, float_dtype) for v in tree]
    if float_dtype is not None and tree.is_floating_point():
        tree = tree.to(float_dtype)
    return tree.to(dev)
