"""The port's inference CLI (``ospo_tpu_torch.pipeline.inference``) and its
parts — ``compose_config``, ``generate_from_raw_prompts``, round-2
generation from a checkpoint — against the JAX package on the CPU, at the
tiny fp32 size with numpy-seeded inputs."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ospo_tpu.config import Config as JConfig
from ospo_tpu.config import compose_config as jcompose
from ospo_tpu.engine.image_engine import ImageGenEngine as JEngine
from ospo_tpu.image_processing import ImageProcessor as JImageProcessor
from ospo_tpu.processing import Processor as JProcessor
from ospo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from ospo_tpu.train import checkpoint as jckpt
from ospo_tpu.train import lora as jlora
from ospo_tpu_torch.config import Config as TConfig
from ospo_tpu_torch.config import compose_config as tcompose
from ospo_tpu_torch.engine.image_engine import ImageGenEngine as TEngine
from ospo_tpu_torch.ops.build import KernelError
from ospo_tpu_torch.pipeline import inference
from ospo_tpu_torch.processing import Processor as TProcessor
from ospo_tpu_torch.tokenizer import ByteTokenizer as TByteTokenizer
from ospo_tpu_torch.utils.png import read_png

torch.set_num_threads(2)
# torch's CPU exp (MKL's vector math) sets itself up on its first call; in
# some processes the worker thread's share of that first parallel call came
# out ~1e-4 off, and every later call was exact: make that call here, once on
# this thread and once spread over both threads
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
LONG = "A very long prompt " * 14 + "that no file system takes as a name"


def _plain(x):
    return json.loads(json.dumps(x))


# ---------------------------------------------------------------------------
# compose_config
# ---------------------------------------------------------------------------


def _write_configs(root, base):
    os.makedirs(root / "model", exist_ok=True)
    os.makedirs(root / "data", exist_ok=True)
    (root / "model" / "small.yaml").write_text(
        "model_path: ./from_group\nwidth: 8\nprecision: ${precision}\n")
    (root / "data" / "d.yaml").write_text("data_path: ./group.json\nbatch_size: 3\n")
    (root / "base.yaml").write_text(base)
    return str(root)


@pytest.mark.parametrize("case", ["inference", "overrides", "self_first",
                                  "null_group", "no_self"])
def test_compose_config_matches_jax(tmp_path, case):
    """The nested dict of ``compose_config`` equals ``ospo_tpu``'s:
    ``configs/inference.yaml`` as it is and with dot-list overrides; a
    config whose ``_self_`` comes before a group (the group's keys win); a
    group set to null (skipped); no ``_self_`` (the primary merges last)."""
    overrides = ()
    if case in ("inference", "overrides"):
        cdir, name = CONFIGS, "inference"
        if case == "overrides":
            overrides = ["batch_size=2", "model.model_path=null",
                         "generation_config.cfg_weight=3.5", "seed=[0,1]",
                         "precision=fp32"]
    else:
        defaults = {"self_first": "  - _self_\n  - model: small\n  - data: d\n",
                    "null_group": "  - model: null\n  - data: d\n  - _self_\n",
                    "no_self": "  - model: small\n  - data: d\n"}[case]
        cdir = _write_configs(tmp_path, "defaults:\n" + defaults
                              + "precision: bf16\nbatch_size: 9\n"
                              "model:\n  width: 4\n  depth: 2\n")
        name = "base"
    ref = jcompose(cdir, name, overrides=overrides)
    got = tcompose(cdir, name, overrides=overrides)
    assert isinstance(got, TConfig)
    assert _plain(got) == _plain(ref)
    if case == "self_first":
        assert got.model.width == 8 and got.model.depth == 2
    if case == "no_self":
        assert got.model.width == 4 and got.batch_size == 9
    if case == "overrides":
        assert got.generation_config.cfg_weight == 3.5 and got.seed == [0, 1]
        assert got.model.precision == "fp32"


def test_compose_config_reads_the_command_line_unless_given_overrides(monkeypatch):
    """``overrides=None`` reads ``a.b=c`` arguments from ``sys.argv`` (as the
    JAX package does); ``()`` reads none."""
    monkeypatch.setattr("sys.argv", ["prog", "--config_name", "inference",
                                     "batch_size=5", "kv_quant=bf16"])
    got = tcompose(CONFIGS, "inference")
    assert _plain(got) == _plain(jcompose(CONFIGS, "inference"))
    assert got.batch_size == 5 and got.kv_quant == "bf16"
    assert tcompose(CONFIGS, "inference", overrides=()).batch_size == 24


# ---------------------------------------------------------------------------
# the engine's raw-prompt entry and the CLI loop
# ---------------------------------------------------------------------------


def test_generate_from_raw_prompts_builds_the_jax_t2i_strings():
    """Each raw prompt goes through the T2I template before the engine
    generates: the strings equal the JAX engine's, in order."""
    prompts = ["A red cube on a blue sphere", "Zwei Katzen / two cats", "é ü"]
    seen = {}

    def stub(processor, key):
        def generate_images(batch, seed=0):
            seen[key] = (list(batch), seed)
            return np.zeros((len(batch), 2, 2, 3), np.uint8)
        return types.SimpleNamespace(processor=processor,
                                     generate_images=generate_images)

    JEngine.generate_from_raw_prompts(
        stub(JProcessor(JByteTokenizer(512), JImageProcessor(image_size=16)),
             "jax"), prompts, seed=3)
    TEngine.generate_from_raw_prompts(
        stub(TProcessor(TByteTokenizer(512)), "port"), prompts, seed=3)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][0].endswith("<begin_of_image>")


def _inference_config(tmp_path, prompts, key, **extra):
    data = tmp_path / f"{key}.json"
    data.write_text(json.dumps(prompts))
    return {"seed": [0, 1], "batch_size": 2, "data_path": str(data),
            "save_path": str(tmp_path / key), "model_preset": "tiny",
            "generation_config": {"temperature": 1.0, "cfg_weight": 5.0},
            **extra}


def _tree(root):
    return {f: (json.load(open(os.path.join(root, f)))
                if f.endswith(".json") else None)
            for f in sorted(os.listdir(root))}


def test_inference_main_writes_the_same_tree_as_jax(tmp_path, monkeypatch):
    """Two prompts (one with a ``/``, one whose name is over 255 bytes) ×
    two seeds, and a third prompt whose batch fails: the port's ``main``
    writes the same file names as ``ospo_tpu``'s ``main`` (the long prompt
    under ``longprompt_{seed}_{n:04d}.png``, the counter running over the
    call) and the same ``error_sample.json``; its PNGs decode to 16×16 RGB
    uint8 images.  A second call regenerates only the prompts whose own
    names do not exist (the long one; the failing one fails again)."""
    from ospo_tpu.pipeline import inference as jinference

    prompts = ["A red/blue moon", LONG, "BROKEN prompt"]
    assert len(f"{LONG}_0.png".encode()) > 255

    def failing(real):
        def gen(self, raw_prompts, seed=0):
            if any(p.startswith("BROKEN") for p in raw_prompts):
                raise RuntimeError("a batch that fails")
            return real(self, raw_prompts, seed=seed)
        return gen

    monkeypatch.setattr(JEngine, "generate_from_raw_prompts",
                        failing(JEngine.generate_from_raw_prompts))
    asked = []
    real = TEngine.generate_from_raw_prompts

    def spy(self, raw_prompts, seed=0):
        asked.append(list(raw_prompts))
        return real(self, raw_prompts, seed=seed)

    monkeypatch.setattr(TEngine, "generate_from_raw_prompts", failing(spy))
    jinference.main(JConfig.from_nested(
        _inference_config(tmp_path, prompts, "j", decode_segments=1)))
    tconf = TConfig.from_nested(_inference_config(
        tmp_path, prompts, "t", device="cpu", quantize="int8", kv_quant="int8"))
    inference.main(tconf)
    jtree, ttree = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert ttree == jtree
    assert sorted(ttree) == ["A red_blue moon_0.png", "A red_blue moon_1.png",
                             "error_sample.json", "longprompt_0_0000.png",
                             "longprompt_1_0001.png"]
    assert ttree["error_sample.json"] == ["BROKEN prompt", "BROKEN prompt"]
    for f in ttree:
        if f.endswith(".png"):
            img = read_png(str(tmp_path / "t" / f))
            assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    asked.clear()
    inference.main(tconf)
    assert asked == [[LONG], [LONG]]  # per seed; the BROKEN batches fail first
    assert sorted(os.listdir(tmp_path / "t")) == sorted(ttree)


def test_second_call_generates_nothing(tmp_path, monkeypatch):
    """With every image on disk under its own name, ``generate_all`` asks
    the engine for nothing and writes nothing."""
    calls = []

    def gen(raw_prompts, seed=0):
        calls.append(list(raw_prompts))
        return np.full((len(raw_prompts), 4, 4, 3), 7, np.uint8)

    engine = types.SimpleNamespace(generate_from_raw_prompts=gen)
    config = TConfig.from_nested({"seed": [0, 5], "batch_size": 2,
                                  "save_path": str(tmp_path / "out")})
    prompts = ["a cat", "a dog", "a/b"]
    inference.generate_all(config, engine, prompts)
    assert len(calls) == 4 and sorted(os.listdir(tmp_path / "out")) == sorted(
        f"{p.replace('/', '_')}_{s}.png" for p in prompts for s in (0, 5))
    calls.clear()
    inference.generate_all(config, engine, prompts)
    assert calls == []
    assert len(os.listdir(tmp_path / "out")) == 6


def test_kernel_error_escapes_generate_all(tmp_path):
    """A kernel that does not build or launch fails the run: the per-batch
    ``except`` passes ``KernelError`` on and writes no ``error_sample.json``."""
    def gen(raw_prompts, seed=0):
        raise KernelError("decode_attention: launch failed")

    config = TConfig.from_nested({"seed": [0], "save_path": str(tmp_path)})
    with pytest.raises(KernelError, match="launch failed"):
        inference.generate_all(
            config, types.SimpleNamespace(generate_from_raw_prompts=gen), ["x"])
    assert os.listdir(tmp_path) == []


def test_engine_arguments_of_main(monkeypatch):
    """``main``'s engine: the config's CFG weight, temperature, KV cache,
    segments and batch cap; ``decode_kernel`` is accepted and selects
    nothing; ``speculative`` > 0 on the config's ``shbd`` cache raises as
    in the JAX engine."""
    from ospo_tpu_torch.models import janus as tjanus
    from ospo_tpu_torch.pipeline.model_factory import get_model

    config = tcompose(CONFIGS, "inference", overrides=[
        "model_path=null", "model_preset=tiny", "device=cpu",
        "decode_kernel=true", "decode_segments=4",
        "generation_config.cfg_weight=3.0"])
    model, _, proc = get_model(config)
    assert isinstance(model, tjanus.JanusModel)
    assert "lm_head" not in model.params["language_model"]
    assert "vision_model" not in model.params
    engine = inference.build_engine(config, model, proc)
    assert (engine.cfg_weight, engine.temperature, engine.kv_quant,
            engine.kv_layout, engine.batch_cap) == (3.0, 1.0, "int8", "shbd", 24)
    assert engine.image_token_num == model.cfg.num_gen_tokens
    assert engine.decode_segments == 4 and engine.speculative == 0
    with pytest.raises(ValueError, match="per-row offsets"):
        inference.build_engine(TConfig({**config, "speculative": 2}), model, proc)


# ---------------------------------------------------------------------------
# round-2 generation from a JAX checkpoint
# ---------------------------------------------------------------------------


def _np_lora(cfg, rank, seed):
    """A JAX-layout LoRA tree with non-zero B."""
    rng = np.random.default_rng(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size
    widths = {"q_proj": (d, d), "k_proj": (d, d), "v_proj": (d, d),
              "o_proj": (d, d), "gate_proj": (d, f), "up_proj": (d, f),
              "down_proj": (f, d)}
    return {n: {"a": (rng.uniform(-1, 1, (cfg.num_layers, i, rank))
                      / i ** 0.5).astype(np.float32),
                "b": (rng.standard_normal((cfg.num_layers, rank, o)) * 0.05
                      ).astype(np.float32)}
            for n, (i, o) in widths.items()}


def test_round_two_forced_logits_match_jax(tmp_path):
    """``get_model`` with a synthetic HF checkpoint (fp32) and a LoRA
    checkpoint written by the JAX package as ``ckpt_path``: the
    teacher-forced CFG logits of the port's engine equal the JAX engine's
    on the same prompts and forced tokens, within the step-3 slice's 2e-4
    (``tests/test_torch_slice.py``).  Unquantized: the two merges differ
    by fp32 rounding, which an int8 quantize after them can turn into a
    step of a weight (``test_torch_train.py::test_get_model_merges_ckpt_path``
    holds the int8 merge to that)."""
    from ospo_tpu.models import janus as jjanus
    from ospo_tpu.models.synthetic import write_synthetic_checkpoint
    from ospo_tpu.pipeline.model_factory import get_model as jget_model
    from ospo_tpu.processing import t2i_prompt as j_t2i
    from ospo_tpu_torch.pipeline.model_factory import get_model as tget_model
    from ospo_tpu_torch.processing import t2i_prompt as t_t2i

    cfg = jjanus.tiny_janus_config()
    base = write_synthetic_checkpoint(str(tmp_path / "hf"), cfg, seed=4)
    lora = jax.tree.map(jnp.asarray, _np_lora(cfg.language, 4, 5))
    jckpt.save_checkpoint(str(tmp_path / "lora"), 2, lora,
                          jlora.LoraConfig(rank=4, alpha=8))
    conf = {"model_path": base, "ckpt_path": str(tmp_path / "lora"),
            "quantize": None, "drop_lm_head": True,
            "drop_understanding": True}
    jmodel, _, jproc = jget_model(JConfig.from_nested(conf))
    tmodel, _, tproc = tget_model(TConfig.from_nested({**conf, "device": "cpu"}))
    n_img = cfg.num_gen_tokens
    forced = np.random.default_rng(6).integers(0, cfg.image_token_size,
                                               (2, n_img))
    prompts = ["A red cube on top of a blue sphere", "Two cats"]
    ref = JEngine(jmodel, jproc, image_token_num=n_img, img_size=16,
                  patch_size=2, kv_quant=False, kv_layout="shbd"
                  ).forced_cfg_logits([j_t2i(jproc, p) for p in prompts], forced)
    got = TEngine(tmodel, tproc, image_token_num=n_img, img_size=16,
                  patch_size=2, kv_quant=False
                  ).forced_cfg_logits([t_t2i(tproc, p) for p in prompts], forced)
    assert got.shape == ref.shape == (2, n_img, cfg.image_token_size)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
