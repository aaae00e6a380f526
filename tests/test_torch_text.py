"""The port's text decode (steps 1, 2 and 4a) against the JAX package on the
CPU: templates and host helpers, sampling, ``llama.forward(prefix_kv=)``,
``TextGenEngine`` and the three pipeline steps.

Both packages compute on the same numpy weights at the JAX package's tiny
sizes in fp32.  torch and JAX draw different random numbers, so sampled
paths are compared by distribution and greedy paths by token ids.
"""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ospo_tpu import chat as jchat
from ospo_tpu.engine import text_engine as jte
from ospo_tpu.image_processing import ImageProcessor
from ospo_tpu.models import janus as jjanus
from ospo_tpu.models import llama as jllama
from ospo_tpu.ops import quant as jquant
from ospo_tpu.ops import sampling as jsampling
from ospo_tpu.pipeline import templates as jtemplates
from ospo_tpu.processing import Processor as JProcessor
from ospo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from ospo_tpu.utils import english as jenglish
from ospo_tpu_torch import chat as tchat
from ospo_tpu_torch.engine import text_engine as tte
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models import llama as tllama
from ospo_tpu_torch.models.weights import from_jax_params
from ospo_tpu_torch.ops import sampling as tsampling
from ospo_tpu_torch.pipeline import templates as ttemplates
from ospo_tpu_torch.processing import Processor as TProcessor
from ospo_tpu_torch.tokenizer import ByteTokenizer as TByteTokenizer
from ospo_tpu_torch.utils import english as tenglish

torch.set_num_threads(2)
# torch's CPU exp (MKL's vector math) sets itself up on its first call; in
# some processes the worker thread's share of that first parallel call came
# out ~1e-4 off, and every later call was exact: make that call here, once on
# this thread and once spread over both threads
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "tests", "fixtures", "examples")
COMMON = ("You are given an object and must produce three contrastive "
          "prompts, as shown in the following few-shot examples: ")


def _np_janus_params(cfg, seed):
    """The JAX Janus param tree filled from numpy with the JAX init's
    distributions, without compiling the JAX init."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name[0] == "b" or name.endswith("bias"):
            return np.zeros(leaf.shape, np.float32)
        if "norm" in name or name == "scale":
            return np.ones(leaf.shape, np.float32)
        std = (2.0 / np.prod(leaf.shape[:3])) ** 0.5 if len(leaf.shape) == 4 else 0.02
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jjanus.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _processors(eos=None):
    """Byte-tokenizer processors of both packages; ``eos`` replaces the eos
    id (the early-exit test makes a token the greedy run emits eos)."""
    jt, tt = JByteTokenizer(512), TByteTokenizer(512)
    if eos is not None:
        jt = type("J", (JByteTokenizer,), {"eos_id": property(lambda s: eos)})(512)
        tt = type("T", (TByteTokenizer,), {"eos_id": property(lambda s: eos)})(512)
    return (JProcessor(jt, ImageProcessor(image_size=16), num_image_tokens=4),
            TProcessor(tt))


@pytest.fixture(scope="module")
def models():
    """One tiny Janus (int8 and fp32 trunks) in both packages."""
    cfg = jjanus.tiny_janus_config()
    params = _np_janus_params(cfg, 0)
    out = {}
    for mode in ("fp32", "int8"):
        lm = dict(params["language_model"])
        if mode == "int8":
            lm["layers"] = {n: (jquant.quantize_matrix(w) if n in jquant.QUANTIZABLE
                                else w) for n, w in lm["layers"].items()}
        tree = {**params, "language_model": lm}
        out[mode] = (jjanus.JanusModel(cfg, tree),
                     tjanus.JanusModel(tjanus.tiny_janus_config(),
                                       from_jax_params(tree), torch.device("cpu")))
    return out


def _engines(models, mode="fp32", eos=None, **kw):
    jmodel, tmodel = models[mode]
    jproc, tproc = _processors(eos)
    return jte.TextGenEngine(jmodel, jproc, **kw), tte.TextGenEngine(tmodel, tproc, **kw)


# ---------------------------------------------------------------------------
# templates and host helpers
# ---------------------------------------------------------------------------

def _renders(t, family, key):
    """Every rendered prompt of one template family and key, under the
    three step-2 seeds (the negative templates draw from ``random``)."""
    out = []
    for seed in (0, 1, 2):
        random.seed(seed)
        np.random.seed(seed)
        if family == "element":
            convs = [t.get_element_conversation(key)]
        elif family == "negative":
            convs = [t.get_negative_conversation(key, p, prompt)
                     for p in ("replace", "swap", "drop")
                     for prompt in ("A red cube and a blue sphere", "Two cats")]
        elif family == "dense":
            convs = [t.get_dense_conversation(key, "A red cube", "A blue cube")]
        else:
            convs = [t.get_vqa_conversation(key, "A red cube on a blue sphere.")]
        for system, conv in convs:
            if conv is None:
                out.append(None)
                continue
            chat = jchat if t is jtemplates else tchat
            out.append(chat.apply_sft_template(conv, system_prompt=system))
    return out


@pytest.mark.parametrize("family,key", [
    ("element", k) for k in jtemplates.ELEMENT_TEMPLATES] + [
    ("negative", k) for k in jtemplates.NEGATIVE_TEMPLATES] + [
    ("dense", k) for k in jtemplates.DENSE_TEMPLATES] + [
    ("vqa", k) for k in jtemplates.VQA_TEMPLATES])
def test_templates_render_byte_identical(family, key):
    got, ref = _renders(ttemplates, family, key), _renders(jtemplates, family, key)
    assert got == ref and any(r is not None for r in ref)
    assert [r.encode() for r in got if r] == [r.encode() for r in ref if r]


def test_english_helpers_equal():
    for n in range(0, 100):
        assert tenglish.number_to_words(n) == jenglish.number_to_words(n)
    for w in ("cat", "box", "city", "boy", "knife", "man", "sheep", "bus",
              "potato", "leaf", "glass", "teddy bear", "wolf"):
        assert tenglish.plural(w) == jenglish.plural(w)


@pytest.mark.parametrize("cap", [None, 5, 64])
def test_buckets_and_shared_split_equal(models, cap):
    jeng, teng = _engines(models, batch_cap=cap)
    for b in range(1, 70):
        assert teng._batch_bucket(b) == jeng._batch_bucket(b), b
    for n in range(1, 1400, 7):
        assert tte._bucket(n) == jte._bucket(n)
        assert tte._bucket_tail(n) == jte._bucket_tail(n)
    cases = [[COMMON + "a", COMMON + "two dogs in the rain"],
             [COMMON + "same"] * 3,
             ["short", "shorter"],
             [COMMON + "single"],
             ["x" * 70 + "a", "x" * 70 + "b" * 600]]
    for prompts in cases:
        got, ref = teng._shared_split(prompts), jeng._shared_split(prompts)
        assert (got is None) == (ref is None)
        for a, b in zip(got or (), ref or ()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            teng.processor.encode_batch_left_padded(prompts)[0],
            jeng.processor.encode_batch_left_padded(prompts)[0])


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _logits(rows, V, seed, spread=3.0):
    return (np.random.default_rng(seed).standard_normal((rows, V)) * spread
            ).astype(np.float32)


@pytest.mark.parametrize("top_p", [0.0, 0.5, 0.9, 0.999])
def test_nucleus_keep_sets_equal_jax(top_p):
    """The top-k candidates kept (k = 64 over V = 512) and the exact
    filter's keep mask, against JAX's formulas on the same logits."""
    x = _logits(6, 512, 1)
    vals, idx = tsampling.nucleus_topk(torch.from_numpy(x), top_p, tsampling.TOP_P_K)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 64)
    lse = jax.nn.logsumexp(jnp.asarray(x), axis=-1, keepdims=True)
    probs = jnp.exp(jv - lse)
    keep = ((jnp.cumsum(probs, -1) - probs) < top_p).at[..., 0].set(True)
    for r in range(x.shape[0]):
        got = set(idx[r][torch.isfinite(vals[r])].tolist())
        ref = set(np.asarray(ji[r])[np.asarray(keep[r])].tolist())
        assert got == ref and len(got) >= 1
    got = torch.isfinite(tsampling.top_p_filter(torch.from_numpy(x), top_p)).numpy()
    ref = np.isfinite(np.asarray(jsampling.top_p_filter(jnp.asarray(x), top_p)))
    np.testing.assert_array_equal(got, ref)


def test_top_p_filter_ties_cut_by_index():
    """Uniform logits: the exact filter keeps the first ceil(p V) by index,
    not every tied token (``ospo_tpu/ops/sampling.py:27-34``)."""
    x = np.zeros((1, 10), np.float32)
    got = torch.isfinite(tsampling.top_p_filter(torch.from_numpy(x), 0.35)).numpy()
    ref = np.isfinite(np.asarray(jsampling.top_p_filter(jnp.asarray(x), 0.35)))
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == 4


def test_top_p_draws_follow_the_nucleus_distribution():
    """20,000 draws of ``sample_token`` (temperature 0.8, top_p 0.9) from one
    row of logits against the analytic nucleus distribution: no draw
    outside the nucleus, and a chi-squared test at p > 1e-3."""
    from scipy import stats

    x = _logits(1, 300, 2, spread=2.0)[0]
    temp, top_p, n = 0.8, 0.9, 20000
    scaled = x.astype(np.float64) / temp
    order = np.argsort(-scaled, kind="stable")
    p_full = np.exp(scaled - scaled.max())
    p_full /= p_full.sum()
    p_sorted = p_full[order]
    keep = (np.cumsum(p_sorted) - p_sorted) < top_p
    keep[0] = True
    nucleus = order[keep]
    assert 3 <= len(nucleus) <= 64
    expected = p_full[nucleus] / p_full[nucleus].sum()
    gen = torch.Generator().manual_seed(0)
    draws = tsampling.sample_token(
        torch.from_numpy(np.repeat(x[None], n, 0)), gen, temperature=temp,
        top_p=top_p).numpy()
    assert np.isin(draws, nucleus).all()
    counts = np.array([(draws == t).sum() for t in nucleus])
    assert stats.chisquare(counts, expected * counts.sum()).pvalue > 1e-3


def test_greedy_is_argmax_and_sampling_is_seeded():
    x = torch.from_numpy(_logits(4, 512, 3))
    x[1, 7] = x[1, 9] = x[1].max() + 1.0                 # a tie: first index
    g = torch.Generator().manual_seed(0)
    greedy = tsampling.sample_token(x, g, do_sample=False)
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(x.numpy()), -1)))
    assert int(greedy[1]) == 7
    a = tsampling.sample_token(x, torch.Generator().manual_seed(5), top_p=0.5)
    b = tsampling.sample_token(x, torch.Generator().manual_seed(5), top_p=0.5)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# llama.forward(prefix_kv=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [False, "int8"])
def test_prefix_kv_forward_matches_jax(kv_quant):
    """Tail prefill against a batch-shared prefix segment (left-padded
    prefix mask), then 4 cached steps reading it, against
    ``ospo_tpu``'s ``llama.forward(prefix_kv=)`` (XLA path, bshd cache) on
    the same weights.  fp32: hidden states within 1e-5 relative (and 1e-5
    absolute) with the model-dtype cache; with the int8 cache the written
    payload may differ by one step at a rounding tie (<= 1, on < 0.1% of
    elements), so within 1e-4 as the int8 decode test allows."""
    cfg_j, cfg_t = jllama.tiny_config(), tllama.tiny_config()
    jp = jllama.init_params(cfg_j, jax.random.PRNGKey(3))
    tp = from_jax_params({"language_model": jax.tree.map(np.asarray, jp)}
                         )["language_model"]
    rng = np.random.default_rng(4)
    L, H, Dh = cfg_j.num_layers, cfg_j.num_heads, cfg_j.dim_head
    B, T, C, steps = 3, 10, 16, 4
    pk = rng.standard_normal((L, C, H, Dh)).astype(np.float32)
    pv = rng.standard_normal((L, C, H, Dh)).astype(np.float32)
    pmask = np.zeros((1, C), np.int32)
    pmask[0, 5:] = 1
    tmask = np.ones((B, T), np.int32)
    tmask[1, :4] = 0
    tmask[2, :9] = 0
    pos = pmask.sum() + np.asarray(jllama.positions_from_mask(jnp.asarray(tmask)))
    x = rng.standard_normal((B, T, cfg_j.hidden_size)).astype(np.float32)
    jpre = {"k": jnp.asarray(pk), "v": jnp.asarray(pv), "mask": jnp.asarray(pmask)}
    tpre = {"k": torch.from_numpy(pk), "v": torch.from_numpy(pv),
            "mask": torch.from_numpy(pmask)}
    S = T + steps
    jc = jllama.init_kv_cache(cfg_j, B, S, quantized=kv_quant)
    tc = tllama.init_kv_cache(cfg_t, B, S, quantized=kv_quant)
    jh, jc = jllama.forward(jp, cfg_j, jnp.asarray(x), jnp.asarray(tmask),
                            jnp.asarray(pos), kv_cache=jc, self_attn=True,
                            prefix_kv=jpre)
    th, tc = tllama.forward(tp, cfg_t, torch.from_numpy(x), torch.from_numpy(tmask),
                            torch.from_numpy(pos), kv_cache=tc, self_attn=True,
                            prefix_kv=tpre)
    tol = 1e-5 if not kv_quant else 1e-4
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=tol, rtol=tol)
    window = np.concatenate([tmask, np.ones((B, steps), np.int32)], axis=1)
    for step in range(steps):
        xd = rng.standard_normal((B, 1, cfg_j.hidden_size)).astype(np.float32)
        pd = (pos[:, -1] + 1 + step)[:, None]
        jh, jc = jllama.forward(jp, cfg_j, jnp.asarray(xd), jnp.asarray(window),
                                jnp.asarray(pd), kv_cache=jc, prefix_kv=jpre)
        th, tc = tllama.forward(tp, cfg_t, torch.from_numpy(xd),
                                torch.from_numpy(window), torch.from_numpy(pd),
                                kv_cache=tc, prefix_kv=tpre)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=tol, rtol=tol)
    assert tc["length"] == T + steps


def test_prefix_kv_is_refused_off_the_serving_path():
    cfg = tllama.tiny_config()
    tp = from_jax_params({"language_model": jax.tree.map(
        np.asarray, jllama.init_params(jllama.tiny_config(), jax.random.PRNGKey(0)))}
    )["language_model"]
    x = torch.zeros((1, 2, cfg.hidden_size))
    mask = torch.ones((1, 2), dtype=torch.int32)
    pre = {"k": torch.zeros((cfg.num_layers, 4, cfg.num_heads, cfg.dim_head)),
           "v": torch.zeros((cfg.num_layers, 4, cfg.num_heads, cfg.dim_head)),
           "mask": torch.ones(4, dtype=torch.int32)}
    with pytest.raises(ValueError, match="KV cache"):
        tllama.forward(tp, cfg, x, mask, mask, prefix_kv=pre)
    kv = tllama.init_kv_cache(cfg, 1, 8)
    with pytest.raises(NotImplementedError):
        tllama.forward(tp, cfg, x, mask, mask, kv_cache=kv,
                       prefix_kv=pre, remat=True)
    kv = tllama.init_kv_cache(cfg, 1, 8, layout="bshd")
    with pytest.raises(ValueError, match="prefix_kv"):  # as the JAX assert
        tllama.forward(tp, cfg, x, torch.ones((1, 8), dtype=torch.int32), mask,
                       kv_cache=kv, prefix_kv=pre,
                       cache_positions=torch.tensor([2]))


# ---------------------------------------------------------------------------
# TextGenEngine, greedy: token ids identical to ospo_tpu's engine
# ---------------------------------------------------------------------------

GREEDY_CASES = {
    # shared program: ragged tails
    "shared_ragged": ([COMMON + "a red apple on a table", COMMON + "two dogs",
                       COMMON + "an umbrella in the rain"], True),
    # shared program: identical prompts (step 1), one-token tail
    "shared_identical": ([COMMON + "same prompt"] * 2, True),
    # plain program: shared_prefix off
    "plain": ([COMMON + "a red apple on a table", COMMON + "two dogs"], False),
    # plain fallback: common prefix under SHARED_PREFIX_MIN
    "plain_short_prefix": (["a red apple", "a blue bird flying high"], True),
    # plain: a single prompt
    "plain_single": ([COMMON + "alone"], True),
    # shared program: 5 prompts in a batch bucket of 8 (3 pad rows)
    "shared_batch5": ([COMMON + w for w in ("one", "two dogs", "three", "four cats",
                                             "five")], True),
}


@pytest.mark.parametrize("kv_quant", [False, "int8"])
@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_ids_match_jax(models, case, kv_quant):
    """Greedy (``do_sample=False``) ids of the port's engine equal
    ``ospo_tpu``'s on the same int8-weight tiny model, model-dtype or int8
    KV cache, for the plain and the shared-prefix programs."""
    prompts, shared = GREEDY_CASES[case]
    jeng, teng = _engines(models, "int8", max_new_tokens=6, do_sample=False,
                          kv_quant=kv_quant, shared_prefix=shared)
    assert (teng._shared_split(prompts) is not None) == case.startswith("shared")
    got = teng.generate_ids(prompts, seed=0)
    ref = jeng.generate_ids(prompts, seed=0)
    assert got.shape == (len(prompts), 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_greedy_eos_early_exit_matches_jax(models):
    """eos set to a token the greedy run emits: rows stop there (eos after
    it), the ids equal JAX's, and the loop ends at the first check after
    every row has finished (step EOS_CHECK_EVERY of 24)."""
    prompts = [COMMON + "stop here"] * 2
    _, probe = _engines(models, max_new_tokens=4, do_sample=False)
    eos = int(probe.generate_ids(prompts)[0, 2])
    jeng, teng = _engines(models, eos=eos, max_new_tokens=24, do_sample=False)
    seen = []
    teng.step_hook = seen.append
    got = teng.generate_ids(prompts, seed=0)
    np.testing.assert_array_equal(got, jeng.generate_ids(prompts, seed=0))
    first = int(np.argmax(got[0] == eos))
    assert first <= 2 and (got[:, first:] == eos).all()
    assert seen == list(range(teng.EOS_CHECK_EVERY))


def test_sampled_generation_is_seeded_and_top_p_bounded(models):
    """Sampling (temperature, top_p) on the shared program: same seed, same
    ids; another seed, other ids; ids inside the vocabulary.  Decoded text
    stops at eos."""
    _, teng = _engines(models, max_new_tokens=8, temperature=1.2, top_p=0.5)
    prompts = [COMMON + "a red apple", COMMON + "two dogs"]
    a, b = teng.generate_ids(prompts, seed=3), teng.generate_ids(prompts, seed=3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, teng.generate_ids(prompts, seed=4))
    assert a.min() >= 0 and a.max() < 512
    assert all(isinstance(s, str) for s in teng.generate(prompts, seed=3))


@pytest.mark.parametrize("step", ["step1", "step2", "step4"])
def test_chip_smoke_text_configs_equal_yaml(step):
    import importlib.util

    import yaml

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(ROOT, "configs", f"{step}.yaml")) as f:
        assert getattr(mod, f"{step.upper()}_CONFIG") == yaml.safe_load(f)


def test_text_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    from ospo_tpu_torch.pipeline import step1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        step1.main(_cfg("step1", save_path="unused", model_preset="tiny",
                        model_path=None, category="object"))


# ---------------------------------------------------------------------------
# pipeline steps 1, 2 and 4a
# ---------------------------------------------------------------------------

def _cfg(step, **over):
    from ospo_tpu_torch.config import Config, load_yaml

    return Config.from_nested({**load_yaml(os.path.join(ROOT, "configs",
                                                        f"{step}.yaml")), **over})


def _stub_answer(prompt: str) -> str:
    """One deterministic answer per prompt string, carrying every anchor the
    steps parse (element lists, contrastive, dense and question anchors)."""
    h = sum(prompt.encode()) % 997
    return (f"apple{h % 7 == 0 and 's' or ''}, red bird, tree {chr(97 + h % 26)}, "
            f"Contrastive Prompt: A cube number {h}\n"
            f"Step 2. Prompt 1 Dense: A dense scene {h}.\n"
            f"Step 4. Prompt 2 Dense: A different scene {h % 13}.\n"
            f"Questions: Is there a cube? Is it red {h}? Is it big.")


@pytest.fixture()
def stubbed(monkeypatch):
    """Both packages' engines answer with ``_stub_answer``; ``get_model``
    returns no model and each step 4 stops where scoring would start (JAX
    prewarm, engine statistics, model building and 4b are out of the
    comparison)."""
    from ospo_tpu.pipeline import step1 as js1, step2 as js2, step4 as js4
    from ospo_tpu_torch.pipeline import step1 as ts1, step2 as ts2, step4 as ts4

    def generate(self, prompts, **kw):
        return [_stub_answer(p) for p in prompts]

    jproc, tproc = _processors()
    for eng, proc in ((jte.TextGenEngine, jproc), (tte.TextGenEngine, tproc)):
        monkeypatch.setattr(eng, "generate", generate)
    monkeypatch.setattr(jte.TextGenEngine, "prewarm", lambda self, sigs: 0)

    def stop(*a, **kw):
        raise _After4a

    monkeypatch.setattr(js4, "ScoringEngine", stop)
    monkeypatch.setattr(ts4, "ScoringEngine", stop)
    for mod, proc in ((js1, jproc), (js2, jproc), (js4, jproc),
                      (ts1, tproc), (ts2, tproc), (ts4, tproc)):
        fake = type("M", (), {"device": torch.device("cpu"), "mesh": None})()
        monkeypatch.setattr(mod, "get_model",
                            lambda config, p=proc, m=fake: (m, p.tokenizer, p))
    return (js1, js2, js4), (ts1, ts2, ts4)


class _After4a(Exception):
    """Raised where the JAX step 4 would start scoring."""


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_steps_write_byte_identical_files_under_a_stub_engine(stubbed, tmp_path):
    """Steps 1 (a category, then the combine over the fixture element files),
    2 (2a and 2b over the fixture base prompts) and 4a (over the fixture
    long prompts) of both packages, each engine's ``generate`` replaced by
    one function of the prompt string: every JSON they write is
    byte-identical."""
    import shutil

    quotas = {"attribute1_color": 2, "attribute1_shape": 2,
              "attribute1_texture": 2, "attribute2": 4, "layout1": 4,
              "layout2": 3, "layout3": 3, "non-spatial": 10, "complex": 10}
    out = {}
    for name, (s1, s2, s4) in (("jax", stubbed[0]), ("torch", stubbed[1])):
        root = tmp_path / name
        s1dir = root / "step1"
        os.makedirs(s1dir)
        for f in os.listdir(os.path.join(EXAMPLES, "step1")):
            if f.endswith("_element.json") and f != "color_element.json":
                shutil.copy(os.path.join(EXAMPLES, "step1", f), s1dir / f)
        s1.main(_cfg("step1", category="color", max_len=2, batch_size=4,
                     save_path=str(s1dir), category_num=quotas))
        s2.main(_cfg("step2", batch_size=4, save_path=str(root / "step2"),
                     data_path=str(s1dir / "base_prompt.json")))
        # 4b is asked for (image_path set): both steps reach scoring
        with pytest.raises(_After4a):
            s4.main(_cfg("step4", batch_size=4, save_path=str(root / "step4"),
                         data_path=os.path.join(EXAMPLES, "step2",
                                                "long_prompt.json")))
        out[name] = {f: _read(root / f) for f in (
            "step1/color_element.json", "step1/base_prompt.json",
            "step2/negative_prompt.json", "step2/long_prompt.json",
            "step4/vqa_prompt.json")}
    for f, data in out["jax"].items():
        assert out["torch"][f] == data, f
    records = json.loads(out["torch"]["step2/long_prompt.json"])
    assert len(records) == 40 and all(len(r["long_prompt"]) == 3 for r in records)
    assert all(n for r in records for n in r["negative_prompt"])
    vqa = json.loads(out["torch"]["step4/vqa_prompt.json"])
    assert len(vqa) == 40 and all(len(r["question"]) == 4 for r in vqa)


def test_steps_run_end_to_end_on_cpu(tmp_path):
    """Steps 1, 2 and 4a of the port with the real engine on the tiny
    random model (int8 weights and KV cache, shared prefix, as their
    configs), a few new tokens each: the files come out with the
    reference's schema."""
    from ospo_tpu_torch.pipeline import step1, step2, step4

    tiny = {"model_path": None, "model_preset": "tiny", "device": "cpu",
            "batch_size": 2}
    gen = lambda cfg: {**cfg.generation_config, "max_new_tokens": 4}  # noqa: E731
    c1 = _cfg("step1", **tiny, category="object", max_len=1,
              save_path=str(tmp_path / "step1"))
    c1.generation_config = gen(c1)
    step1.main(c1)
    assert isinstance(json.loads(_read(tmp_path / "step1" / "object_element.json")),
                      list)
    base = [r for r in json.loads(_read(os.path.join(EXAMPLES, "step1",
                                                     "base_prompt.json")))
            if r["sub_category"] == "attribute1_color"]
    with open(tmp_path / "base.json", "w") as f:
        json.dump(base, f)
    c2 = _cfg("step2", **tiny, data_path=str(tmp_path / "base.json"),
              save_path=str(tmp_path / "step2"))
    c2.generation_config = gen(c2)
    step2.main(c2)
    dense = json.loads(_read(tmp_path / "step2" / "long_prompt.json"))
    assert [r["item_id"] for r in dense] == [r["item_id"] for r in base]
    assert all(len(r["negative_prompt"]) == len(r["long_prompt"]) == 3
               for r in dense)
    c4 = _cfg("step4", **tiny, image_path=None, e_idx=3,
              data_path=os.path.join(EXAMPLES, "step2", "long_prompt.json"),
              save_path=str(tmp_path / "step4"))
    c4.generation_config = gen(c4)
    step4.main(c4)
    vqa = json.loads(_read(tmp_path / "step4" / "vqa_prompt.json"))
    assert len(vqa) == 3 and all(
        r["question"][-1] == step4.GLOBAL_QUESTION.format(r["prompt"].rstrip("."))
        for r in vqa)
