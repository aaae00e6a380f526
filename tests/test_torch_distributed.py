"""Multi-process data parallel of the port on the CPU (gloo): the result
merge against ``ospo_tpu.io``, ``scripts/run_multihost_torch.sh`` with
steps 1, 2 and 5 (as ``tests/test_multihost_pipeline.py`` runs
``scripts/run_multihost.sh``; step 5 also against the JAX package's
step 5), the launcher's failure handling, and the refusals of the model
factory and the trainer.

Every subprocess has a timeout, and a ``finally`` kills what is left of it.
"""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ospo_tpu import io as jio
from ospo_tpu_torch import io as tio
from ospo_tpu_torch.utils.png import write_png

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LAUNCHER = os.path.join(REPO, "scripts", "run_multihost_torch.sh")
FIXTURES = os.path.join(HERE, "fixtures", "examples")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, HERE, env.get("PYTHONPATH", "")])
    env["PYTHON"] = sys.executable
    env["OMP_NUM_THREADS"] = "2"   # each process's share of the CPU
    env.pop("XLA_FLAGS", None)
    return env


def _start(nproc: int, *args: str) -> subprocess.Popen:
    return subprocess.Popen(["bash", LAUNCHER, str(nproc), *args],
                            env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT,
                            start_new_session=True)


def _finish(*procs, timeout: float = 300):
    """Wait for every launcher; → their outputs.  Whatever is still running
    at the end (a launcher and its processes) is killed."""
    try:
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out.decode()))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()


def test_dedup_by_item_id_matches_jax():
    rng = random.Random(0)
    records = [{"item_id": f"{i:07d}", "v": j} for j in range(3)
               for i in rng.sample(range(40), 25)]
    rng.shuffle(records)
    assert tio.dedup_by_item_id(records) == jio.dedup_by_item_id(records)
    assert tio.shard_for_process(list(range(7))) == list(range(7))
    assert tio.shard_for_process(list(range(7)), 1, 3) == [1, 4]
    assert tio.gather_objects({"a": 1}) == [{"a": 1}]


def test_two_process_merge_equals_one_process(tmp_path):
    """``save_json_sharded`` of strided shards (rank 1 also emits item 0)
    writes, from rank 0 alone, the JAX package's dedup of the concatenated
    shards, which is what one process writes; ``merge_element_sets`` gives
    the union; ``shard_for_process``'s defaults give each rank its stride;
    each rank prints the gloo backend and the CPU."""
    two, one = tmp_path / "two", tmp_path / "one"
    (r2, out2), (r1, out1) = _finish(
        _start(2, "torch_dist_worker", "merge", str(two)),
        _start(1, "torch_dist_worker", "merge", str(one)))
    assert r2 == 0 and r1 == 0, out2 + out1
    for rank in range(2):
        assert (f"# distributed runtime: process {rank}/2 @ localhost:"
                in out2) and out2.count("backend gloo device cpu") == 2, out2
    items = json.load(open(os.path.join(FIXTURES, "step1", "base_prompt.json")))
    ids = [r["item_id"] for r in items]
    shards = [json.load(open(two / f"shard{r}.json")) for r in range(2)]
    assert shards == [ids[0::2], ids[1::2]]
    assert json.load(open(one / "shard0.json")) == ids

    rec = lambda r: {**r, "negative_prompt": [f"neg-{r['item_id']}"]}  # noqa: E731
    concat = [rec(r) for r in items[0::2]] + [rec(r) for r in items[1::2]] \
        + [rec(items[0])]
    merged = (two / "merged.json").read_text()
    assert json.loads(merged) == jio.dedup_by_item_id(concat)
    assert merged == (one / "merged.json").read_text()
    assert json.load(open(two / "elements.json")) == ["shared", "w0", "w1"]
    assert json.load(open(one / "elements.json")) == ["shared", "w0"]


def test_launcher_stops_the_others_when_one_fails():
    """Rank 1 exits with 3 while rank 0 sleeps ten minutes: the launcher
    returns 3 and stops rank 0 at once."""
    t0 = time.time()
    ((rc, out),) = _finish(_start(2, "torch_dist_worker", "fail"), timeout=120)
    assert rc == 3, out
    assert time.time() - t0 < 100, out
    assert "stopping the others" in out


def _step2_yaml(tmp_path) -> str:
    cfg = tmp_path / "step2.yaml"
    cfg.write_text(
        "seed_list: [0,1,2]\n"
        "batch_size: 2\n"
        "e_idx: 4\n"
        f"data_path: {os.path.join(FIXTURES, 'step1', 'base_prompt.json')}\n"
        f"save_path: {tmp_path / 'step2'}\n"
        "model_preset: tiny\n"
        "device: cpu\n"
        "generation_config:\n"
        "  do_sample: true\n"
        "  temperature: 1.2\n"
        "  top_p: 0.5\n"
        "  max_new_tokens: 8\n")
    return str(cfg)


def _step1_yaml(tmp_path) -> str:
    cfg = tmp_path / "step1.yaml"
    cfg.write_text(
        "seed: 42\n"
        "batch_size: 2\n"
        "max_len: 3\n"
        f"save_path: {tmp_path / 'step1'}\n"
        "model_preset: tiny\n"
        "device: cpu\n"
        "generation_config:\n"
        "  do_sample: true\n"
        "  temperature: 1.3\n"
        "  max_new_tokens: 8\n")
    return str(cfg)


def test_two_process_steps_1_and_2_launcher(tmp_path):
    """Step 2 in two processes (tiny, CPU): every item exactly once, with
    three negatives and three long prompts each.  Step 1 in two processes:
    a list of unique elements, written by rank 0 alone."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (r2, out2), (r1, out1) = _finish(
        _start(2, "ospo_tpu_torch.pipeline.step2", "--cfg_path",
               _step2_yaml(tmp_path / "a")),
        _start(2, "ospo_tpu_torch.pipeline.step1", "--cfg_path",
               _step1_yaml(tmp_path / "b"), "--category", "object"))
    assert r2 == 0, out2
    assert r1 == 0, out1
    out = json.load(open(tmp_path / "a" / "step2" / "long_prompt.json"))
    items = json.load(open(os.path.join(FIXTURES, "step1",
                                        "base_prompt.json")))[:4]
    assert [r["item_id"] for r in out] == [r["item_id"] for r in items]
    for rec in out:
        assert len(rec["negative_prompt"]) == 3
        assert len(rec["long_prompt"]) == 3
    elements = json.load(open(tmp_path / "b" / "step1" / "object_element.json"))
    assert isinstance(elements, list)  # may be empty under a random model
    assert len(elements) == len(set(elements)) and elements == sorted(elements)
    assert out1.count("# Generated [object] elements") == 1, out1


def _write_step5_data(tmp_path) -> str:
    rng = np.random.default_rng(3)
    records = []
    for i in range(4):
        d = tmp_path / "step3" / "base" / "attribute" / f"{i:07d}"
        d.mkdir(parents=True)
        for j in range(2):
            write_png(str(d / f"{j:02d}.png"),
                      rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
        records.append({
            "item_id": f"{i:07d}", "category": "attribute",
            "prompt": f"a photo of object {i}",
            "chosen": str(d / "00.png"), "rejected": str(d / "01.png"),
        })
    (tmp_path / "train.json").write_text(json.dumps(records))
    return str(tmp_path / "train.json")


def _step5_yaml(tmp_path, name: str, dp: int, model_path: str,
                resume: str) -> str:
    """The JAX test's config (tests/test_multihost_pipeline.py:228-252):
    tiny, LoRA rank 4, dropout 0, batch 2, 3 steps; on the CPU; the model
    from ``model_path``, the adapters from the checkpoint ``resume``."""
    model = f"model:\n  model_path: {model_path}\n"
    if dp:
        model += f"  data_parallel: {dp}\n"
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(
        "base:\n"
        f"  save_path: {tmp_path / name}\n"
        "  exp_name: mh\n"
        f"  resume: {resume}\n"
        + model +
        "device: cpu\n"
        "use_peft: True\n"
        "lora:\n  lora_rank: 4\n  lora_alpha: 8\n  lora_dropout: 0.0\n"
        "dataset:\n  train:\n    batch_size: 2\n"
        f"    data_path: {tmp_path / 'train.json'}\n"
        "optimizer:\n  init_lr: 1e-3\n  scheduler_type: constant\n"
        "experiment:\n  seed: 0\n  max_training_steps: 3\n"
        "  max_epochs: 2\n  log_steps: 1\n"
        "  gradient_checkpointing: False\n"
        "algo:\n  beta: 10\n  gamma_beta_ratio: 0.5\n")
    return str(cfg)


def test_two_process_step5_matches_one_process(tmp_path):
    """Step 5 in two processes (each takes its row of the global batch of 2,
    gradients averaged over the group) ends with the adapters of one
    process on the whole batch, and with those of the JAX package's step 5
    in one process, within the JAX test's tolerance (atol 1e-5, rtol
    1e-4).  All three start from the same tiny synthetic directory (the
    two writers' bytes are equal, ``test_tiny_directory_is_byte_equal_to_
    jax``) and the same adapters (a step-0 checkpoint through
    ``base.resume``).  Rank 0 alone writes the checkpoints and the
    scalars, and the logged loss and grad_norm of the port's runs agree."""
    from ospo_tpu_torch.models import janus as tjanus
    from ospo_tpu_torch.models import synthetic as tsyn
    from ospo_tpu_torch.train import checkpoint as tckpt
    from ospo_tpu_torch.train import lora as tlora

    _write_step5_data(tmp_path)
    cfg = tjanus.tiny_janus_config()
    model_path = tsyn.write_synthetic_checkpoint(str(tmp_path / "model"),
                                                 cfg, seed=0)
    lcfg = tlora.LoraConfig.from_dict(
        {"lora_rank": 4, "lora_alpha": 8, "lora_dropout": 0.0})
    start = tckpt.save_checkpoint(str(tmp_path / "init"), 0, tlora.init_lora(
        cfg.language, lcfg, seed=0), lcfg)
    yaml = lambda name, dp: _step5_yaml(  # noqa: E731
        tmp_path, name, dp, model_path, start)
    env = dict(_env(), JAX_PLATFORMS="cpu", OSPO_PLATFORM="cpu",
               OSPO_COMPILE_CACHE="off")
    ref = subprocess.Popen(
        [sys.executable, "-m", "ospo_tpu.pipeline.step5", "--cfg_path",
         yaml("jax", 0)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True)
    (r2, out2), (r1, out1), (rj, outj) = _finish(
        _start(2, "ospo_tpu_torch.pipeline.step5", "--cfg_path",
               yaml("two", 2)),
        _start(1, "ospo_tpu_torch.pipeline.step5", "--cfg_path",
               yaml("one", 0)), ref)
    assert r2 == 0, out2
    assert r1 == 0, out1
    assert rj == 0, outj
    assert out2.count("# Saved checkpoint:") == 1, out2
    one = np.load(tmp_path / "one" / "mh" / "step_000003" / "lora.npz")
    for other in ("two", "jax"):
        got = np.load(tmp_path / other / "mh" / "step_000003" / "lora.npz")
        assert sorted(got.files) == sorted(one.files), other
        for k in one.files:
            np.testing.assert_allclose(got[k], one[k], atol=1e-5, rtol=1e-4,
                                       err_msg=f"{other}: {k}")
    logs = [[json.loads(x) for x in (tmp_path / d / "mh" / "scalars.jsonl")
             .read_text().splitlines()] for d in ("two", "one")]
    assert [x["step"] for x in logs[0]] == [1, 2, 3]
    for a, b in zip(*logs):
        for k in ("train/loss", "train/grad_norm", "train/rewards/margins"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_iter_batches_takes_each_rank_its_rows(tmp_path):
    """``iter_batches(part=(rank, n))``: the rank's contiguous rows of each
    global batch in the seeded order; a batch ``n`` does not divide is a
    ValueError."""
    from ospo_tpu_torch.pipeline.datasets import PreferenceDataset
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import load_tokenizer
    from ospo_tpu_torch.image_processing import load_image_processor

    proc = Processor(load_tokenizer(None, vocab_size=512),
                     load_image_processor(None, image_size=32))
    ds = PreferenceDataset(seed=0, data_path=_write_step5_data(tmp_path),
                           processor=proc)
    ids = lambda part: [[x["item_id"] for x in b]  # noqa: E731
                        for b in ds.iter_batches(4, seed=5, part=part)]
    whole = ids((0, 1))
    assert ids((0, 2)) == [b[:2] for b in whole]
    assert ids((1, 2)) == [b[2:] for b in whole]
    assert ids((3, 4)) == [b[3:] for b in whole]
    with pytest.raises(ValueError, match="does not split"):
        ids((0, 3))


def test_data_parallel_refusals(monkeypatch):
    """The model factory: ``data_parallel`` must be 0 or the world size
    under a global scope, 0 or 1 under a local one; ``tensor_parallel``
    must divide the world (``tests/test_torch_parallel.py`` holds the
    rest).  The trainer: more than one process needs a global
    scope (``data_parallel`` unset: ``test_trainer_refuses_what_is_not_
    ported``)."""
    from ospo_tpu_torch.models import janus as tjanus
    from ospo_tpu_torch.pipeline import model_factory
    from ospo_tpu_torch.train import trainer as trainer_mod

    base = {"model_preset": "tiny", "device": "cpu"}
    monkeypatch.setattr(model_factory, "process_count", lambda: 2)
    for over in ({"data_parallel": 2, "mesh_scope": "local"},
                 {"data_parallel": 3, "mesh_scope": "global"}):
        with pytest.raises(ValueError, match="run_multihost_torch.sh"):
            model_factory._reject_unported({**base, **over})
    model_factory._reject_unported({**base, "data_parallel": 2,
                                    "mesh_scope": "global"})
    model_factory._reject_unported({**base, "tensor_parallel": 2})
    with pytest.raises(ValueError, match="tensor_parallel must divide"):
        model_factory._reject_unported({**base, "tensor_parallel": 3})

    model = tjanus.JanusModel.init(tjanus.tiny_janus_config(), seed=0,
                                   device="cpu")
    monkeypatch.setattr(trainer_mod, "process_count", lambda: 2)
    cfg = {"model": {"model_preset": "tiny"}, "device": "cpu",
           "lora": {"lora_rank": 4, "lora_alpha": 8}}
    with pytest.raises(ValueError, match="mesh_scope"):
        trainer_mod.SimPOTrainer(
            {**cfg, "model": {"data_parallel": 2, "mesh_scope": "local"}},
            model, None)
    assert torch.distributed.is_initialized() is False
