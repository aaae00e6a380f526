"""Cases of ``tests/test_torch_parallel.py`` and their worker, started once a
process by ``scripts/run_multihost_torch.sh 2 torch_tp_worker <workdir>
[train]`` (``tests/`` on ``PYTHONPATH``).  It imports only the port.

The test writes two trees into ``<workdir>`` with ``torch.save``:
``llama.pt`` (a tiny Llama trunk) and ``janus.pt`` (a Janus model at the
width ``SERVE_CFG``, fp32).  Each rank joins the world on the CPU (gloo),
first loads a tensor-parallel model through ``get_model`` (``tiny`` preset,
int8) and records the shapes of its shard, then runs :func:`run_cases` on
its shards of the two trees under the mesh that made.  Model rank 0 saves
the results as ``<workdir>/tp_out.pt``; each rank writes its shapes to
``shapes<rank>.json``.  The test runs :func:`run_cases` on the whole trees
in its own process and compares.

With ``train``, each rank instead runs :func:`run_train_cases` (step 5's
trainer at tp = 2) on the inputs the test wrote to ``<workdir>/train.pt``
and saves what it read as ``<workdir>/train_out<rank>.pt``; the test runs
the same cases in one process.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import llama

# wide enough that every weight mode shards at tp = 2: the int4g
# row-parallel shards keep whole scale groups (256 / 2 = 128 columns)
SERVE_CFG = dataclasses.replace(
    janus_lib.tiny_janus_config(),
    language=llama.tiny_config(hidden_size=256, intermediate_size=512))
WEIGHT_MODES = ("int8", "w8a8", "int4", "int4g")


def processor(cfg):
    from ospo_tpu_torch.image_processing import ImageProcessor
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import ByteTokenizer

    return Processor(ByteTokenizer(vocab_size=cfg.language.vocab_size),
                     ImageProcessor(image_size=cfg.image_size),
                     num_image_tokens=cfg.num_image_tokens)


def _quantized(params, mode):
    from ospo_tpu_torch.ops import quant

    lm = dict(params["language_model"])
    lm["layers"] = quant.quantize_layers(dict(lm["layers"]), mode)
    return {**params, "language_model": lm}


def run_cases(llama_params, janus_params, shard=lambda p: p) -> dict:
    """Every case on trees that ``shard`` cuts to this rank's shard (the
    identity in one process) → numpy results by name."""
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine
    from ospo_tpu_torch.engine.scoring import ScoringEngine
    from ospo_tpu_torch.engine.text_engine import TextGenEngine

    out = {}
    cfg = SERVE_CFG
    proc = processor(cfg)

    # the trunk's forward (tests/test_multichip.py:70)
    lcfg = llama.tiny_config(num_heads=4)
    lp = shard({"language_model": llama_params})["language_model"]
    ids = torch.arange(24).reshape(2, 12) % lcfg.vocab_size
    mask = torch.ones((2, 12), dtype=torch.int32)
    with torch.inference_mode():
        h, _ = llama.forward(lp, lcfg, llama.embed_tokens(lp, ids), mask,
                             llama.positions_from_mask(mask))
        out["llama_logits"] = llama.logits_from_hidden(lp, h).numpy()

    def model(params):
        return janus_lib.JanusModel(cfg, shard(params), torch.device("cpu"))

    base = model(janus_params)
    kw = dict(image_token_num=cfg.num_gen_tokens, img_size=cfg.gen_image_size,
              patch_size=cfg.vq.downsample_factor)
    prompts = [f"a red cube {i}" for i in range(4)]
    forced = np.random.default_rng(0).integers(
        0, cfg.image_token_size, (4, cfg.num_gen_tokens))
    for kv_quant, layout, segments in (("int8", "shbd", 2),
                                       (False, "bshd", 1)):
        eng = ImageGenEngine(base, proc, kv_quant=kv_quant, kv_layout=layout,
                             decode_segments=segments, **kw)
        tag = f"{kv_quant}_{layout}_{segments}"
        out[f"forced_{tag}"] = eng.forced_cfg_logits(prompts, forced)
        out[f"tokens_{tag}"] = eng.generate_tokens(prompts, seed=3)
    ragged = ImageGenEngine(base, proc, **kw)
    out["ragged_tokens"] = ragged.generate_tokens(["one", "two", "three"],
                                                  seed=0)
    out["ragged_forced"] = ragged.forced_cfg_logits(["one", "two", "three"],
                                                    forced[:3])
    sjd = ImageGenEngine(base, proc, kv_layout="bshd", speculative=4, **kw)
    out["sjd_tokens"] = sjd.generate_tokens(prompts[:2], seed=1)

    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (16, 16, 3), np.uint8) for _ in range(3)]
    for share in (True, False):
        scores = ScoringEngine(base, proc).score_images(
            images, ["Is there a cube?", "Is it red?"], share_prefix=share)
        out[f"scores_{share}"] = np.asarray(
            [[s["local_score"], s["global_score"]] for s in scores])

    text = TextGenEngine(base, proc, max_new_tokens=8, do_sample=False)
    out["text_ids"] = text.generate_ids(
        ["hello world", "abc", "a longer prompt here", "zz"])
    shared = "You write short answers about colours and shapes. " * 2
    out["text_ids_shared"] = text.generate_ids(
        [shared + "red?", shared + "a blue cube?"])

    for mode in WEIGHT_MODES:
        qm = model(_quantized(janus_params, mode))
        eng = ImageGenEngine(qm, proc, kv_quant="int8", decode_segments=2, **kw)
        out[f"w_{mode}_tokens"] = eng.generate_tokens(prompts, seed=7)
        out[f"w_{mode}_forced"] = eng.forced_cfg_logits(prompts, forced)
    return out


# ---------------------------------------------------------------------------
# step 5 under tensor parallel
# ---------------------------------------------------------------------------


def _whole(trainer, tree) -> dict:
    """``{path: numpy}`` of a trained tree (or a gradient tree like it),
    each leaf gathered whole over the model group (a collective)."""
    from ospo_tpu_torch.parallel import mesh as mesh_lib
    from ospo_tpu_torch.train.optim import leaves

    if trainer.mesh is None:
        return {p: t.detach().clone().numpy() for p, t in leaves(tree)}
    return {p: mesh_lib.gather_model(t, trainer._axes[p]).numpy()
            for p, t in leaves(tree)}


def _local(trainer) -> dict:
    """This rank's own leaves of the trained tree and of the optimizer
    state, as they are (shards and replicas)."""
    from ospo_tpu_torch.train.optim import leaves

    return {"trained": {p: t.detach().clone()
                        for p, t in leaves(trainer.trainable)},
            "opt": {k: v.clone() for k, v in trainer.opt.state_dict().items()}}


def run_train_cases(inp: dict, root: str, tp: int = 1,
                    shard=lambda p: p) -> dict:
    """Step 5's trainer on the tiny Janus at ``tp`` (the model cut by
    ``shard``; one process at 1) → results by name.  ``inp`` holds the
    configs (``lora_conf``, ``full_conf``), JAX-layout weights
    (``lora_params``, ``full_params``), a LoRA tree with non-zero B
    (``lora``), two batches and a JAX LoRA checkpoint (``jax_ckpt``); each
    trainer writes under ``root``."""
    import copy

    from ospo_tpu_torch.config import Config
    from ospo_tpu_torch.models.weights import from_jax_params
    from ospo_tpu_torch.ops.quant import QUANTIZABLE
    from ospo_tpu_torch.train.trainer import SimPOTrainer

    cfg = janus_lib.tiny_janus_config()
    proc = processor(cfg)
    batch, batch2 = inp["batch"], inp["batch2"]

    def trainer(conf, params, name, **exp):
        conf = copy.deepcopy(conf)
        conf["model"] = {"tensor_parallel": tp}
        conf["base"]["save_path"] = os.path.join(root, name)
        conf["experiment"].update(exp)
        model = janus_lib.JanusModel(cfg, shard(from_jax_params(params)),
                                     torch.device("cpu"))
        return SimPOTrainer(Config.from_nested(conf), model, proc)

    def micro(t, seed=None, b=batch):
        """One micro-batch: loss, grad_norm and the whole gradient."""
        _, m, g = t.loss_and_grads(*b, dropout_seed=seed)
        g = t._reduce_grads(g)
        return float(m["loss"]), float(t._global_norm(g)), _whole(t, g)

    out = {}
    # LoRA, B non-zero: one micro-batch, without and with dropout
    t = trainer(inp["lora_conf"], inp["lora_params"], "lora")
    t._set_trainable(inp["lora"])
    out["lora"] = micro(t)
    t.lora_cfg = dataclasses.replace(t.lora_cfg, dropout=0.1)
    out["lora_dropout"] = micro(t, seed=5)
    t.lora_cfg = dataclasses.replace(t.lora_cfg, dropout=0.0)
    # two optimizer steps, then a checkpoint
    out["lora_metrics"] = [{k: float(v) for k, v in t._step(*b).items()}
                           for b in (batch, batch2)]
    out["lora_after"] = _whole(t, t.trainable)
    t.global_step = 2
    out["lora_ckpt"] = t.save()
    out["lora_local"] = _local(t)

    # full fine-tune (the language model and the gen head): one step,
    # then a second and a checkpoint
    t = trainer(inp["full_conf"], inp["full_params"], "full")
    out["full_metrics"] = {k: float(v) for k, v in t._step(*batch).items()}
    out["full_wq"] = _whole(t, t.trainable)["language_model/layers/wq"]
    t._step(*batch2)
    t.global_step = 2
    out["full_ckpt"] = t.save()
    out["full_local"] = _local(t)

    # the int8 and w8a8 trunks: this rank's quantized shards and one
    # micro-batch
    for mode in ("int8", "w8a8"):
        t = trainer(inp["lora_conf"], inp["lora_params"], mode,
                    quantize_base=mode)
        t._set_trainable(inp["lora"])
        layers = t.model.params["language_model"]["layers"]
        out[f"{mode}_layers"] = {n: {k: v.clone() for k, v in layers[n].items()}
                                 for n in QUANTIZABLE}
        out[mode] = micro(t)

    # a JAX checkpoint resumed
    t = trainer(inp["lora_conf"], inp["lora_params"], "resumed")
    t.resume(inp["jax_ckpt"])
    out["resumed"] = _whole(t, t.trainable)
    out["resumed_step"] = t.global_step
    return out


def main() -> None:
    from ospo_tpu_torch import io as io_lib
    from ospo_tpu_torch.parallel import mesh as mesh_lib
    from ospo_tpu_torch.pipeline.model_factory import get_model
    from ospo_tpu_torch.platform import maybe_init_distributed

    workdir = sys.argv[1]
    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    rank = io_lib.process_index()
    if sys.argv[2:] == ["train"]:
        mesh = mesh_lib.create_mesh(2)
        out = run_train_cases(
            torch.load(os.path.join(workdir, "train.pt"), weights_only=False),
            workdir, 2, lambda p: mesh_lib.shard_janus_params(p, mesh))
        torch.save(out, os.path.join(workdir, f"train_out{rank}.pt"))
        print(f"# tp train worker {rank} done", flush=True)
        return
    model, _, _ = get_model({"model_preset": "tiny", "device": "cpu",
                             "quantize": "int8", "tensor_parallel": 2})
    mesh = mesh_lib.current_mesh()
    lm = model.params["language_model"]
    shapes = {"embed": list(lm["embed"].shape),
              "lm_head": list(lm["lm_head"].shape),
              "gen_head": list(model.params["gen_head"]["head"]["w"].shape),
              "mesh": [mesh.data, mesh.model, mesh.model_rank,
                       mesh.data_index]}
    for name, w in lm["layers"].items():
        shapes[name] = ({k: list(t.shape) for k, t in w.items()}
                        if isinstance(w, dict) else list(w.shape))
    with open(os.path.join(workdir, f"shapes{rank}.json"), "w") as f:
        json.dump(shapes, f)

    out = run_cases(torch.load(os.path.join(workdir, "llama.pt")),
                    torch.load(os.path.join(workdir, "janus.pt")),
                    shard=lambda p: mesh_lib.shard_janus_params(p, mesh))
    if mesh.model_rank == 0:
        torch.save(out, os.path.join(workdir, "tp_out.pt"))
    print(f"# tp worker {rank} done", flush=True)


if __name__ == "__main__":
    main()
