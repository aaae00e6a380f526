"""The port's step 4b against the JAX package on the CPU: ``ScoringEngine``
(the pre-image program, the single-segment program and the unshared
fallback; bf16-role model-dtype and int8 caches; ragged question counts;
slices under a small row-token budget; the out-of-memory halving), the
yes/no ids of both tokenizers, the cached multi-token forward of
``llama.forward``, and step 4b end to end (``run_scoring`` and ``main`` over
one PNG tree, a corrupt PNG included).

Set-up as ``tests/test_scoring.py``: the tiny Janus in fp32, the byte
tokenizer, 32 × 32 images; both packages compute on the same numpy weights.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ospo_tpu.engine import scoring as jscoring
from ospo_tpu.image_processing import ImageProcessor as JImageProcessor
from ospo_tpu.models import janus as jjanus
from ospo_tpu.models import llama as jllama
from ospo_tpu.processing import Processor as JProcessor
from ospo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from ospo_tpu_torch.engine import scoring as tscoring
from ospo_tpu_torch.image_processing import ImageProcessor
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models import llama as tllama
from ospo_tpu_torch.models.weights import from_jax_params
from ospo_tpu_torch.processing import Processor
from ospo_tpu_torch.tokenizer import ByteTokenizer
from ospo_tpu_torch.utils.png import write_png

torch.set_num_threads(2)
# the first parallel torch.exp of a process can come out ~1e-4 off in the
# worker thread's share (MKL VML set-up); make that call here
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))

# p_yes / p_no per (image, question): |port - JAX| within P_ABS and within
# P_REL of the value (the tiny model's probabilities are ~1/512, so the
# relative bound is the one that bites)
P_ABS, P_REL = 2e-4, 1e-3
# the bound tests/test_scoring.py holds the int8 cache's scores to
INT8_SCORE = 0.15

PER_IMAGE = [
    ["Is there a dog?", "Is it red?", "Does it match the prompt?"],
    ["Is the sky blue?", "Does it match?"],
    ["Is there a cat?", "Is it big?", "Is it outdoors?",
     "Does it match the prompt?"],
]


def _np_janus_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name[:1] == "b" or name.endswith("bias"):
            return np.zeros(leaf.shape, np.float32)
        if "norm" in name or name == "scale":
            return np.ones(leaf.shape, np.float32)
        std = (2.0 / np.prod(leaf.shape[:3])) ** 0.5 if len(leaf.shape) == 4 else 0.02
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jjanus.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    """The tiny Janus and byte-tokenizer processors of both packages."""
    cfg = jjanus.tiny_janus_config()
    params = _np_janus_params(cfg, 0)
    jmodel = jjanus.JanusModel(cfg, params)
    tmodel = tjanus.JanusModel(tjanus.tiny_janus_config(),
                               from_jax_params(params), torch.device("cpu"))
    jproc = JProcessor(JByteTokenizer(512), JImageProcessor(image_size=32),
                       num_image_tokens=cfg.num_image_tokens)
    tproc = Processor(ByteTokenizer(512), ImageProcessor(image_size=32),
                      num_image_tokens=4)
    return jmodel, tmodel, jproc, tproc


def _images(n, seed, side=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (side, side, 3)).astype(np.uint8)
            for _ in range(n)]


def _assert_scores(a, b, score_tol=None):
    """Per (image, question) p_yes / p_no within P_ABS and P_REL; local and
    global scores within ``score_tol`` when given, else as the p's."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra["answer_metadata"]) == len(rb["answer_metadata"])
        for ma, mb in zip(ra["answer_metadata"], rb["answer_metadata"]):
            for k in ("p_yes", "p_no"):
                assert abs(ma[k] - mb[k]) <= min(P_ABS, P_REL * abs(mb[k]) + 1e-9), \
                    (k, ma[k], mb[k])
        tol = score_tol if score_tol is not None else 2 * P_ABS
        assert abs(ra["local_score"] - rb["local_score"]) <= tol
        assert abs(ra["global_score"] - rb["global_score"]) <= tol


@pytest.mark.parametrize("kv_quant", [False, True], ids=["model_dtype_cache",
                                                         "int8_cache"])
@pytest.mark.parametrize("program", ["pre_image", "single_segment", "unshared"])
def test_scoring_engine_matches_jax(pair, program, kv_quant):
    """Three images with 3, 2 and 4 questions through one program of both
    engines: p's within P_ABS / P_REL; with the int8 cache the scores also
    within test_scoring.py's int8 bound.  The pre-image split is engaged
    where asked for and off where not."""
    jmodel, tmodel, jproc, tproc = pair
    kw = {"kv_quant": kv_quant, "pre_image_prefix": program == "pre_image"}
    je, te = jscoring.ScoringEngine(jmodel, jproc, **kw), \
        tscoring.ScoringEngine(tmodel, tproc, **kw)
    imgs = _images(3, 11)
    share = program != "unshared"
    if share:
        jprep = je.prepare_shared_multi([Image.fromarray(i) for i in imgs],
                                        PER_IMAGE)
        tprep = te.prepare_shared_multi(imgs, PER_IMAGE)
        assert (tprep.pre is None) == (jprep.pre is None) == (program != "pre_image")
        assert tprep.row_tokens == jprep.row_tokens
        assert tprep.q_counts == jprep.q_counts
        for a, b in zip(tprep.operands, jprep.operands):
            np.testing.assert_array_equal(a, b)
        if tprep.pre is not None:
            for a, b in zip(tprep.pre, jprep.pre):
                np.testing.assert_array_equal(a, b)
    ref = je.score_images_multi([Image.fromarray(i) for i in imgs], PER_IMAGE,
                                share_prefix=share)
    out = te.score_images_multi(imgs, PER_IMAGE, share_prefix=share)
    _assert_scores(out, ref, INT8_SCORE if kv_quant else None)
    assert te.counts["unshared_calls"] == (0 if share else 1)
    assert set(out[0]) == {"local_score", "global_score", "answer_metadata"}


def test_slices_under_a_small_row_token_budget(pair):
    """Five images under a budget of two images a slice (3 balanced slices
    of 2, the last padded with its last image) score as the JAX engine's
    single slice does."""
    jmodel, tmodel, jproc, tproc = pair
    imgs = _images(5, 12)
    qs = [PER_IMAGE[i % 3] for i in range(5)]
    ref = jscoring.ScoringEngine(jmodel, jproc).score_images_multi(
        [Image.fromarray(i) for i in imgs], qs)
    te = tscoring.ScoringEngine(tmodel, tproc)
    prep = te.prepare_shared_multi(imgs, qs)
    te.row_token_budget = 2 * prep.row_tokens + 1
    seen = []
    orig = te._execute_shared_slice

    def spy(ops, pre, qc):
        seen.append(ops[0].shape[0])
        return orig(ops, pre, qc)

    te._execute_shared_slice = spy
    out = te.score_images_multi(imgs, qs, prep=prep)
    assert seen == [2, 2, 2]
    _assert_scores(out, ref)


def test_out_of_memory_halves_the_slice_then_falls_back(pair):
    """A CUDA out-of-memory error halves the slice (sticky, counted); at one
    image the engine falls back for good to the unshared forward; any other
    error propagates and downgrades nothing."""
    jmodel, tmodel, jproc, tproc = pair
    imgs = _images(4, 13)
    qs = [PER_IMAGE[0]] * 4
    ref = jscoring.ScoringEngine(jmodel, jproc).score_images_multi(
        [Image.fromarray(i) for i in imgs], qs)
    te = tscoring.ScoringEngine(tmodel, tproc)
    orig = te._execute_shared_slice

    def tight(ops, pre, qc):
        if ops[0].shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return orig(ops, pre, qc)

    te._execute_shared_slice = tight
    _assert_scores(te.score_images_multi(imgs, qs), ref)
    assert te.counts["oom_retries"] == 2 and not te._shared_oom
    prep = te.prepare_shared_multi(imgs, qs)
    assert te._fit_images(prep.row_tokens) == 1

    te2 = tscoring.ScoringEngine(tmodel, tproc)
    te2._execute_shared_slice = lambda *a: (_ for _ in ()).throw(
        torch.cuda.OutOfMemoryError("CUDA out of memory (test)"))
    _assert_scores(te2.score_images_multi(imgs, qs), ref)
    assert te2._shared_oom and te2.counts["unshared_calls"] == 1

    te3 = tscoring.ScoringEngine(tmodel, tproc)
    te3._execute_shared_slice = lambda *a: (_ for _ in ()).throw(
        RuntimeError("unrelated"))
    with pytest.raises(RuntimeError, match="unrelated"):
        te3.score_images_multi(imgs, qs)
    assert not te3._shared_oom and te3.counts["oom_retries"] == 0


def test_yes_no_ids_match_jax(tmp_path):
    """The readout ids: the last id of each word without special tokens, for
    the byte tokenizer and for an HF ``tokenizers`` BPE trained here."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    from ospo_tpu.tokenizer import HFTokenizer as JHF
    from ospo_tpu_torch.tokenizer import HFTokenizer as THF

    hf = Tokenizer(models.BPE(unk_token="[UNK]"))
    hf.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    hf.train_from_iterator(
        ["yes no Yes No yesterday nobody Yesterday Nothing answer"] * 20,
        trainers.BpeTrainer(vocab_size=300, special_tokens=["[UNK]"],
                            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    hf.save(str(tmp_path / "tokenizer.json"))
    model = type("M", (), {"device": torch.device("cpu")})()
    for jt, tt in ((JByteTokenizer(512), ByteTokenizer(512)),
                   (JHF(str(tmp_path)), THF(str(tmp_path)))):
        je = jscoring.ScoringEngine(None, JProcessor(jt))
        te = tscoring.ScoringEngine(model, Processor(tt))
        assert (te.yes_ids, te.no_ids) == (je.yes_ids, je.no_ids)


@pytest.mark.parametrize("kv_quant", [False, "int8"])
def test_cached_multi_token_forward_matches_jax(pair, kv_quant):
    """``llama.forward`` with a cached T > 1 step (no ``self_attn``, shared
    ``cache_len``) after a prefix prefill, with a batch-shared ``prefix_kv``,
    against the JAX forward on the ``shbd`` cache: hidden states within
    1e-4, and the step's written rows equal."""
    jmodel, tmodel, _, _ = pair
    jc, tc = jmodel.cfg.language, tmodel.cfg.language
    jp, tp = jmodel.params["language_model"], tmodel.params["language_model"]
    rng = np.random.default_rng(21)
    B, P, T, C = 3, 8, 5, 4
    pre_x = rng.standard_normal((1, C, jc.hidden_size)).astype(np.float32)
    pre_m = np.array([[0, 1, 1, 1]], np.int32)
    x = rng.standard_normal((B, P, jc.hidden_size)).astype(np.float32)
    mask = np.ones((B, P), np.int32)
    mask[1, :3] = 0
    sx = rng.standard_normal((B, T, jc.hidden_size)).astype(np.float32)
    smask = np.ones((B, T), np.int32)
    smask[2, :2] = 0
    pos = (3 + np.cumsum(mask, -1) - 1).clip(3).astype(np.int32)
    spos = (3 + mask.sum(-1, keepdims=True) - 1
            + np.maximum(np.cumsum(smask, -1), 1)).astype(np.int32)
    window = np.concatenate([mask, smask], -1)

    def j_run():
        pkv = jllama.init_kv_cache(jc, 1, C)
        _, pkv = jllama.forward(jp, jc, pre_x, pre_m,
                                jllama.positions_from_mask(pre_m),
                                kv_cache=pkv, self_attn=True)
        prefix = {"k": pkv["k"][:, 0], "v": pkv["v"][:, 0], "mask": pre_m}
        kv = jllama.init_kv_cache(jc, B, P + T, layout="shbd",
                                  quantized=kv_quant)
        _, kv = jllama.forward(jp, jc, x, mask, pos, kv_cache=kv,
                               self_attn=True, cache_layout="shbd",
                               prefix_kv=prefix)
        h, kv = jllama.forward(jp, jc, sx, window, spos, kv_cache=kv,
                               cache_layout="shbd", prefix_kv=prefix)
        return np.asarray(h), np.asarray(kv["k"])

    def t_run():
        pkv = tllama.init_kv_cache(tc, 1, C)
        tm = torch.as_tensor(pre_m)
        _, pkv = tllama.forward(tp, tc, torch.as_tensor(pre_x), tm,
                                tllama.positions_from_mask(tm), kv_cache=pkv,
                                self_attn=True)
        prefix = {"k": pkv["k"][:, :, :, 0], "v": pkv["v"][:, :, :, 0],
                  "mask": tm}
        kv = tllama.init_kv_cache(tc, B, P + T, quantized=kv_quant)
        _, kv = tllama.forward(tp, tc, torch.as_tensor(x), torch.as_tensor(mask),
                               torch.as_tensor(pos), kv_cache=kv, self_attn=True,
                               prefix_kv=prefix)
        h, kv = tllama.forward(tp, tc, torch.as_tensor(sx),
                               torch.as_tensor(window), torch.as_tensor(spos),
                               kv_cache=kv, prefix_kv=prefix)
        assert kv["length"] == P + T
        return h.numpy(), kv["k"].numpy()

    (jh, jk), (th, tk) = j_run(), t_run()
    valid = smask.astype(bool)
    np.testing.assert_allclose(th[valid], jh[valid], atol=1e-4, rtol=1e-4)
    if kv_quant:   # int8 rows: a rounding tie may land one step apart
        assert np.abs(tk[:, P:].astype(int) - jk[:, P:].astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(tk[:, P:], jk[:, P:], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# step 4b end to end
# ---------------------------------------------------------------------------

ITEMS = [
    {"item_id": "0000001", "category": "attribute",
     "sub_category": "attribute1_color", "prompt": "A red cube",
     "question": ["Is there a cube?", "Is it red?",
                  "This image is generated by a prompt: A red cube. Does "
                  "this image accurately represent the prompt?"]},
    {"item_id": "0000002", "category": "layout", "sub_category": "layout1",
     "prompt": "A cat left of a dog",
     "question": ["Is there a cat?",
                  "This image is generated by a prompt: A cat left of a dog. "
                  "Does this image accurately represent the prompt?"]},
    {"item_id": "0000003", "category": "layout", "sub_category": "layout2",
     "prompt": "Two birds", "question": [
         "Are there birds?", "Are there two?", "Do they fly?",
         "This image is generated by a prompt: Two birds. Does this image "
         "accurately represent the prompt?"]},
]


def _png_tree(root, corrupt=None):
    """base|negative/<category>/<item_id>/0{0,1,2}.png, 32 × 32, written with
    the port's ``write_png``; ``corrupt`` names one file to truncate."""
    rng = np.random.default_rng(31)
    for item in ITEMS:
        for kind in ("base", "negative"):
            d = os.path.join(root, kind, item["category"], item["item_id"])
            os.makedirs(d, exist_ok=True)
            for i in range(3):
                write_png(os.path.join(d, f"{i:02d}.png"),
                          rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))
    if corrupt:
        path = os.path.join(root, *corrupt)
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])


def _cfg(**kw):
    from ospo_tpu_torch.config import Config

    return Config.from_nested({"score_rows": 4, "score_failure_gate": True,
                               **kw})


def _assert_records(a, b):
    """train.json records: identical but for the scores, which agree within
    2 P_ABS (gaps) and P_ABS / P_REL (p's); the same pairs chosen."""
    assert [(r["item_id"], r["chosen"], r["rejected"]) for r in a] == \
        [(r["item_id"], r["chosen"], r["rejected"]) for r in b]
    for ra, rb in zip(a, b):
        assert {k: v for k, v in ra.items() if k != "metadata"} == \
            {k: v for k, v in rb.items() if k != "metadata"}
        ma, mb = ra["metadata"], rb["metadata"]
        assert set(ma) == set(mb) == {"score_metadata", "base_meatadata",
                                      "negative_metadata"}
        for k in ("local_gap", "global_gap"):
            assert abs(ma["score_metadata"][k] - mb["score_metadata"][k]) <= 4 * P_ABS
        for side in ("base_meatadata", "negative_metadata"):
            assert set(ma[side]) == set(mb[side])
            for key in ma[side]:
                assert ma[side][key]["path"] == mb[side][key]["path"]
                _assert_scores([ma[side][key]], [mb[side][key]])


def test_run_scoring_matches_jax_with_a_corrupt_png(pair, tmp_path):
    """Both packages' ``run_scoring`` over one PNG tree (18 images in chunks
    of 4, one PNG truncated): the same records and pairs, scores within the
    stated bounds, equal per-category counts, and the corrupt PNG costs one
    image in both."""
    from ospo_tpu.pipeline import step4 as jstep4
    from ospo_tpu_torch.pipeline import step4 as tstep4

    jmodel, tmodel, jproc, tproc = pair
    root = str(tmp_path / "step3")
    _png_tree(root, corrupt=("negative", "layout", "0000003", "01.png"))
    config = _cfg(image_path=root, save_path=str(tmp_path / "out"))
    items = [dict(x) for x in ITEMS]
    jpairs, jsum = jstep4.run_scoring(config, jscoring.ScoringEngine(
        jmodel, jproc, kv_quant=True), [dict(x) for x in ITEMS])
    te = tscoring.ScoringEngine(tmodel, tproc, kv_quant=True)
    tpairs, tsum = tstep4.run_scoring(config, te, items)
    assert tsum == jsum
    assert sum(c["failed"] for c in tsum.values()) == 1
    assert sum(c["images"] for c in tsum.values()) == 18
    assert te.counts == {"oom_retries": 0, "unshared_calls": 0,
                         "per_image_retries": 0}
    _assert_records(tpairs, jpairs)


def test_step4_main_writes_the_jax_files(pair, tmp_path, monkeypatch):
    """Both packages' ``step4.main`` on ``configs/step4.yaml`` (4a skipped:
    ``vqa_prompt.json`` exists; the model from ``get_model`` is the shared
    tiny one): ``train.json`` records and ``score_summary.json`` agree."""
    from ospo_tpu.config import build_config as jbuild
    from ospo_tpu.pipeline import step4 as jstep4
    from ospo_tpu_torch.config import build_config as tbuild
    from ospo_tpu_torch.pipeline import step4 as tstep4

    jmodel, tmodel, jproc, tproc = pair
    root = str(tmp_path / "step3")
    _png_tree(root)
    out = {}
    for name, step, build, model, proc in (
            ("jax", jstep4, jbuild, jmodel, jproc),
            ("torch", tstep4, tbuild, tmodel, tproc)):
        save = tmp_path / name
        os.makedirs(save)
        (save / "vqa_prompt.json").write_text(json.dumps(ITEMS))
        monkeypatch.setattr(step, "get_model", lambda c, m=model, p=proc:
                            (m, p.tokenizer, p))
        step.main(build(cfg_path="configs/step4.yaml", use_cli=False, overrides=[
            f"save_path={save}", f"image_path={root}", "model_path=null",
            "model_preset=tiny", "device=cpu", "score_rows=4"]))
        out[name] = {f: json.loads((save / f"{f}.json").read_text())
                     for f in ("train", "score_summary")}
    assert out["torch"]["score_summary"] == out["jax"]["score_summary"]
    assert len(out["torch"]["train"]) >= 1
    _assert_records(out["torch"]["train"], out["jax"]["train"])


def test_step4_main_on_cpu_with_the_tiny_preset(tmp_path):
    """The port's step 4 end to end from its own random tiny model on the
    CPU, 4b only: train.json and score_summary.json come out with the
    reference's schema and every image scored."""
    from ospo_tpu_torch.config import build_config
    from ospo_tpu_torch.pipeline import step4

    root = str(tmp_path / "step3")
    _png_tree(root)
    save = tmp_path / "out"
    os.makedirs(save)
    (save / "vqa_prompt.json").write_text(json.dumps(ITEMS))
    step4.main(build_config(cfg_path="configs/step4.yaml", use_cli=False, overrides=[
        f"save_path={save}", f"image_path={root}", "model_path=null",
        "model_preset=tiny", "device=cpu"]))
    summary = json.loads((save / "score_summary.json").read_text())
    assert {k: (v["images"], v["scored"], v["failed"]) for k, v in
            summary.items()} == {"attribute": (6, 6, 0), "layout": (12, 12, 0)}
    train = json.loads((save / "train.json").read_text())
    assert sum(v["pairs"] for v in summary.values()) == len(train)
    for rec in train:
        assert set(rec) == {"item_id", "category", "sub_category", "question",
                            "prompt", "chosen", "rejected", "metadata"}


def test_kernel_errors_propagate_through_the_per_image_retry(pair, tmp_path):
    """``score_prepared_chunk`` retries a failed chunk image by image
    (counted) and scores what it can, but a kernel that did not build or
    launch (``ops.build.KernelError``) is no bad image: it propagates from
    the chunk call and from the retry."""
    from ospo_tpu_torch.ops.build import KernelError
    from ospo_tpu_torch.pipeline import step4 as tstep4

    _, tmodel, _, tproc = pair
    root = str(tmp_path / "step3")
    _png_tree(root)
    jobs = tstep4.item_image_jobs(_cfg(image_path=root), ITEMS[0])[:2]
    te = tscoring.ScoringEngine(tmodel, tproc)
    orig = te.score_images_multi
    calls = []

    def chunk_fails(images, qs, **kw):
        calls.append(len(images))
        if len(images) > 1:
            raise RuntimeError("chunk failed (test)")
        return orig(images, qs, **kw)

    te.score_images_multi = chunk_fails
    out = tstep4.score_jobs(te, jobs)
    assert calls == [2, 1, 1] and all(r is not None for r in out)
    assert te.counts["per_image_retries"] == 2

    for fail_at in (2, 1):
        def kernel_fails(images, qs, fail_at=fail_at, **kw):
            if len(images) > 1:
                raise (KernelError if fail_at == 2 else RuntimeError)("x")
            raise KernelError("flash_fwd: CUDA launch failed (test)")

        te.score_images_multi = kernel_fails
        with pytest.raises(KernelError):
            tstep4.score_jobs(te, jobs)


@pytest.mark.parametrize("flags,parts", [
    ({}, {"vision_model", "aligner", "gen_vision_model"}),
    ({"drop_understanding": True}, {"gen_vision_model"}),
    ({"drop_vision": True}, set()),
])
def test_get_model_builds_the_understanding_part_unless_dropped(flags, parts):
    """``get_model`` builds SigLIP and the aligner unless
    ``drop_understanding`` or ``drop_vision`` says not to
    (``ospo_tpu/pipeline/model_factory.py:197-230``), and its processor
    counts the tower's patches as image tokens."""
    from ospo_tpu_torch.pipeline.model_factory import get_model

    model, _, proc = get_model({"model_preset": "tiny", "device": "cpu",
                                **flags})
    assert set(model.params) & {"vision_model", "aligner",
                                "gen_vision_model"} == parts
    assert proc.num_image_tokens == model.cfg.num_image_tokens == 4
    assert proc.image_processor.image_size == 32
