"""The port's step-3 slice as a whole, and its host parts, against the JAX
package on the CPU."""

import importlib.util
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from ospo_tpu.engine.image_engine import ImageGenEngine as JEngine
from ospo_tpu.engine.image_engine import _bucket as j_bucket
from ospo_tpu.image_processing import ImageProcessor
from ospo_tpu.models import janus as jjanus
from ospo_tpu.ops import quant as jquant
from ospo_tpu.processing import Processor as JProcessor
from ospo_tpu.processing import t2i_prompt as j_t2i
from ospo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from ospo_tpu_torch.engine.image_engine import ImageGenEngine as TEngine
from ospo_tpu_torch.engine.image_engine import _bucket as t_bucket
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models.weights import from_jax_params
from ospo_tpu_torch.ops import quant as tquant
from ospo_tpu_torch.processing import Processor as TProcessor
from ospo_tpu_torch.processing import t2i_prompt as t_t2i
from ospo_tpu_torch.tokenizer import ByteTokenizer as TByteTokenizer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "examples", "step2",
                       "long_prompt.json")
PROMPTS = ["A red cube on top of a blue sphere", "Two cats"]


def _np_janus_params(cfg, seed):
    """The JAX Janus param tree, filled from numpy with the JAX init's
    distributions (convs He-normal, other weights N(0, 0.02), norm scales
    1, biases 0) — without compiling the JAX init."""
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


def _processors():
    jproc = JProcessor(JByteTokenizer(512), ImageProcessor(image_size=16),
                       num_image_tokens=4)
    return jproc, TProcessor(TByteTokenizer(512))


@pytest.mark.parametrize("kv_quant", ["int8", False])
def test_forced_cfg_logits_match_jax(kv_quant):
    """The whole slice: prompt batch, prefill, 63 cached decode steps with
    gen head, fp32 CFG combine and gen_embed → gen_aligner feedback, int8
    weights, shbd cache.  JAX runs its XLA read path (which
    tests/test_decode_attention holds equal to its Pallas kernel); the port
    runs the kernels' plain versions.  fp32; logits within 2e-4 (the int8
    KV rows may round a tie differently)."""
    cfg = jjanus.tiny_janus_config()
    params = _np_janus_params(cfg, 0)
    lm = dict(params["language_model"])
    lm["layers"] = {n: (jquant.quantize_matrix(w) if n in jquant.QUANTIZABLE
                        else w) for n, w in lm["layers"].items()}
    jmodel = jjanus.JanusModel(cfg, {**params, "language_model": lm})
    tparams = from_jax_params(params)
    tlayers = tparams["language_model"]["layers"]
    for n in tquant.QUANTIZABLE:  # the port quantizes the same fp32 weights
        tlayers[n] = tquant.quantize_matrix(tlayers[n])
    tmodel = tjanus.JanusModel(tjanus.tiny_janus_config(), tparams,
                               torch.device("cpu"))

    jproc, tproc = _processors()
    n_img = cfg.num_gen_tokens
    forced = np.random.default_rng(0).integers(0, cfg.image_token_size,
                                               (2, n_img))
    jeng = JEngine(jmodel, jproc, image_token_num=n_img, img_size=16,
                   patch_size=2, kv_quant=kv_quant, kv_layout="shbd")
    teng = TEngine(tmodel, tproc, image_token_num=n_img, img_size=16,
                   patch_size=2, kv_quant=kv_quant)
    prompts = [j_t2i(jproc, p) for p in PROMPTS]
    ref = jeng.forced_cfg_logits(prompts, forced)
    got = teng.forced_cfg_logits([t_t2i(tproc, p) for p in PROMPTS], forced)
    assert got.shape == ref.shape == (2, n_img, cfg.image_token_size)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)


def test_build_cfg_batch_equal():
    jproc, tproc = _processors()
    jeng = JEngine(None, jproc)
    teng = TEngine(tjanus.JanusModel(None, {}, torch.device("cpu")), tproc)
    prompts = [j_t2i(jproc, p) for p in PROMPTS + ["x" * 70]]
    for a, b in zip(jeng.build_cfg_batch(prompts),
                    teng.build_cfg_batch(prompts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", [None, 5, 24])
def test_batch_and_prompt_buckets_equal(cap):
    jproc, tproc = _processors()
    jeng = JEngine(None, jproc, batch_cap=cap)
    teng = TEngine(tjanus.JanusModel(None, {}, torch.device("cpu")), tproc,
                   batch_cap=cap)
    for b in range(1, 50):
        assert teng._batch_bucket(b) == jeng._batch_bucket(b), b
    for n in range(1, 400):
        assert t_bucket(n) == j_bucket(n), n


def test_prompt_and_tokenizer_equal():
    jproc, tproc = _processors()
    for p in PROMPTS + ["ünïcode <image_placeholder> tags"]:
        assert t_t2i(tproc, p) == j_t2i(jproc, p)
        assert tproc.tokenizer.encode(p) == jproc.tokenizer.encode(p)
        ids = jproc.tokenizer.encode(p)
        assert tproc.tokenizer.decode(ids) == jproc.tokenizer.decode(ids)
    assert tproc.pad_id == jproc.pad_id


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            out[rel] = json.load(open(path)) if f.endswith(".json") else None
    return out


def test_step3_main_writes_the_same_tree_as_jax(tmp_path):
    """A tiny step 3 on the CPU over two items writes the same relative
    paths and metadata.json as the JAX step 3; the PNGs decode to 16x16
    RGB images."""
    from PIL import Image

    from ospo_tpu.config import Config as JConfig
    from ospo_tpu.pipeline import step3 as jstep3
    from ospo_tpu_torch.config import Config as TConfig
    from ospo_tpu_torch.pipeline import step3 as tstep3

    base = {"seed_list": [0, 1, 2], "batch_size": 2, "model_preset": "tiny",
            "data_path": FIXTURE, "e_idx": 2,
            "generation_config": {"temperature": 1.0, "cfg_weight": 5.0},
            "decode_segments": 1, "drop_lm_head": True}
    jstep3.main(JConfig.from_nested({**base, "save_path": str(tmp_path / "j")}))
    stats = tstep3.main(TConfig.from_nested({
        **base, "save_path": str(tmp_path / "t"), "device": "cpu",
        "quantize": "int8", "kv_quant": "int8", "kv_layout": "shbd"}))
    jtree = {k: v for k, v in _tree(tmp_path / "j").items()
             if not k.endswith("engine_stats.json")}
    ttree = _tree(tmp_path / "t")
    assert ttree == jtree
    assert stats["groups"] == 6 and stats["images"] == 12
    for rel in ttree:
        if rel.endswith(".png"):
            img = np.asarray(Image.open(tmp_path / "t" / rel))
            assert img.shape == (16, 16, 3) and img.dtype == np.uint8


def test_step3_skips_existing_and_falls_back_on_long_names(tmp_path, monkeypatch):
    """Images already on disk are not regenerated; an OSError on save
    retries as longprompt_<name> in the working directory."""
    from ospo_tpu_torch.pipeline import step3 as tstep3

    class FakeEngine:
        image_token_num = 4
        device = torch.device("cpu")
        calls = []

        def generate_images_device(self, prompts, seed=0):
            self.calls.append(len(prompts))
            return torch.full((len(prompts), 2, 2, 3), 7, dtype=torch.uint8)

    sample = json.load(open(FIXTURE))[0]
    cfg = {"batch_size": 4, "seed_list": [0, 1, 2],
           "save_path": str(tmp_path / "out")}
    from ospo_tpu_torch.config import Config

    done = tmp_path / "out" / "base" / sample["category"] / sample["item_id"]
    done.mkdir(parents=True)
    (done / "00.png").write_bytes(b"x")
    eng = FakeEngine()
    stats = tstep3.run_step3(Config(cfg), eng, TProcessor(TByteTokenizer(512)),
                             [sample])
    assert stats["images"] == 5 and eng.calls == [1] * 5
    assert (done / "00.png").read_bytes() == b"x"

    real = tstep3.write_png
    seen = []

    def flaky(path, img):
        seen.append(path)
        if not os.path.basename(path).startswith("longprompt_"):
            raise OSError("File name too long")
        real(str(tmp_path / os.path.basename(path)), img)

    monkeypatch.setattr(tstep3, "write_png", flaky)
    tstep3.save_images(np.zeros((1, 2, 2, 3), np.uint8), ["/nowhere/01.png"])
    assert seen == ["/nowhere/01.png", "longprompt_01.png"]
    assert (tmp_path / "longprompt_01.png").exists()


def test_step3_aborts_when_every_batch_fails(tmp_path):
    from ospo_tpu_torch.config import Config
    from ospo_tpu_torch.pipeline import step3 as tstep3

    class Broken:
        image_token_num = 4
        device = torch.device("cpu")

        def generate_images_device(self, prompts, seed=0):
            raise RuntimeError("device lost")

    sample = json.load(open(FIXTURE))[0]
    with pytest.raises(RuntimeError, match="all 1 batches failed"):
        tstep3.run_step3(Config({"batch_size": 2, "seed_list": [0, 1, 2],
                                 "save_path": str(tmp_path)}),
                         Broken(), TProcessor(TByteTokenizer(512)), [sample])


def test_png_encoder_round_trips_through_pil(tmp_path):
    from PIL import Image

    from ospo_tpu_torch.utils.png import encode_png, read_png, write_png

    img = np.random.default_rng(0).integers(0, 256, (23, 17, 3)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(img)))),
                                  img)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))


def test_chip_smoke_config_equals_step3_yaml():
    import yaml

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(ROOT, "configs", "step3.yaml")) as f:
        assert mod.STEP3_CONFIG == yaml.safe_load(f)


def test_build_config_matches_jax():
    from ospo_tpu.config import build_config as jbuild
    from ospo_tpu_torch.config import build_config as tbuild

    path = os.path.join(ROOT, "configs", "step3.yaml")
    overrides = ["batch_size=8", "generation_config.cfg_weight=3.5",
                 "model_preset=tiny", "device=cpu"]
    a = jbuild(path, overrides=overrides, use_cli=False)
    b = tbuild(path, overrides=overrides, use_cli=False)
    assert b == a and b.generation_config.cfg_weight == 3.5


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    from ospo_tpu_torch.pipeline.model_factory import get_model
    from ospo_tpu_torch.platform import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model({"model_preset": "tiny"})
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("override,error", [
    ({"ckpt_path": "x"}, NotImplementedError),
    ({"tensor_parallel": 2}, NotImplementedError),
    ({"quantize": "int4"}, NotImplementedError),
    ({"quantize": "int_8"}, ValueError),
    ({"model_path": "/does/not/exist"}, FileNotFoundError),
    ({"model_preset": None}, ValueError),
])
def test_get_model_rejects_what_is_not_ported(override, error):
    from ospo_tpu_torch.pipeline.model_factory import get_model

    with pytest.raises(error):
        get_model({"model_preset": "tiny", "device": "cpu", **override})


@pytest.mark.parametrize("kwargs", [{"kv_layout": "bshd"}, {"speculative": 4},
                                    {"kv_quant": "int4"}])
def test_engine_rejects_what_is_not_ported(kwargs):
    model = tjanus.JanusModel(None, {}, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(model, _processors()[1], **kwargs)


def test_generate_images_on_cpu_are_uint8_and_reproducible():
    """Same seed, same images; the engine's step_hook (the profiler's
    probe) sees every step in order after the prefill and changes nothing."""
    cfg = tjanus.tiny_janus_config()
    model = tjanus.JanusModel.init(cfg, seed=0, quantize="int8", device="cpu")
    proc = TProcessor(TByteTokenizer(512))
    eng = TEngine(model, proc, image_token_num=cfg.num_gen_tokens,
                  img_size=16, patch_size=2, kv_quant="int8", batch_cap=4)
    prompts = [t_t2i(proc, p) for p in PROMPTS + ["a third"]]
    a = eng.generate_images(prompts, seed=3)
    seen = []
    eng.step_hook = seen.append
    b = eng.generate_images(prompts, seed=3)
    assert a.shape == (3, 16, 16, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert seen == list(range(cfg.num_gen_tokens))

