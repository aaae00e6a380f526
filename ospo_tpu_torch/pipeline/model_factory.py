"""Model/tokenizer/processor factory for the port's pipeline steps —
counterpart of ``ospo_tpu/pipeline/model_factory.py``.

Resolution (fail-fast, as in the JAX package):

1. ``model_path`` set → it must hold ``*.safetensors``; it is loaded
   (``models/weights.load_janus``);
2. else ``model_preset`` (``tiny`` | ``1b`` | ``7b``) → random init;
3. neither → error.

The model lives on ``config.device`` (default ``cuda``; ``cpu`` only when
asked).  ``ckpt_path`` (a checkpoint of step 5, from either package: LoRA
adapters are merged into the trunk, a full fine-tune's submodules replace
the model's) is applied before ``quantize`` (int8, w8a8, int4, int4g or
int4n) quantizes the trunk (``ospo_tpu/pipeline/model_factory.py:154-177``);
``drop_lm_head``, ``drop_understanding`` (SigLIP and the aligner, :216-230) and
``drop_vision`` (the VQ model, the generation heads and the understanding
tower, :197-214) are honoured by never building those parts.
``tensor_parallel`` > 1 (steps 1–4 and the inference CLI, one process a
card under ``scripts/run_multihost_torch.sh``) shards the built, merged and
quantized model over the model groups of ``parallel/mesh.py`` (:241-257);
each rank keeps its shard.  The
processor's image processor comes from the checkpoint's
``preprocessor_config.json`` or the defaults at the model's image size, and
its image-token count from the model's tower.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

from ospo_tpu_torch.image_processing import load_image_processor
from ospo_tpu_torch.io import process_count
from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.ops import quant
from ospo_tpu_torch.platform import resolve_device
from ospo_tpu_torch.processing import Processor
from ospo_tpu_torch.tokenizer import load_tokenizer

PRESETS = {
    "7b": janus_lib.JANUS_PRO_7B,
    "1b": janus_lib.JANUS_PRO_1B,
}


def has_weights(model_path: Optional[str]) -> bool:
    return bool(model_path and os.path.isdir(model_path)
                and glob.glob(os.path.join(model_path, "*.safetensors")))


def _validate_quantize_mode(config) -> str:
    """'' (model dtype), 'int8', 'w8a8', 'int4', 'int4g' or 'int4n'; an
    unknown spelling (``true`` included, as in the JAX package) is an error
    before the (long) model build."""
    return quant.quant_mode(str(config.get("quantize") or ""))


def _reject_unported(config) -> None:
    """Each process drives one card, so a mesh is a grid of processes:
    ``data_parallel`` x ``tensor_parallel`` must equal the processes it
    spans (``data_parallel`` 0: what the model groups leave).  A global
    scope spans the world the launcher started; a local one this process's
    card, or with ``tensor_parallel`` > 1 the world as well, since a model
    group is made of processes."""
    scope = config.get("mesh_scope") or "local"
    if scope not in ("local", "global"):
        raise ValueError(f"mesh_scope must be local|global, got {scope!r}")
    tp = int(config.get("tensor_parallel") or 1)
    dp = int(config.get("data_parallel") or 0)
    span = process_count() if scope == "global" or tp > 1 else 1
    if tp < 1 or span % tp or dp not in (0, span // tp):
        raise ValueError(
            f"data_parallel={dp} x tensor_parallel={tp} with mesh_scope "
            f"{scope}: the mesh spans {span} process(es), one a card, so "
            f"tensor_parallel must divide {span} and data_parallel be 0 or "
            f"{span} // tensor_parallel; start one process a card with "
            "scripts/run_multihost_torch.sh <nprocs> <module> ...")


def build_model(config, quantize: str = "") -> janus_lib.JanusModel:
    device = resolve_device(config.get("device"))
    parts = {"lm_head": not config.get("drop_lm_head"),
             "vision": not config.get("drop_vision"),
             "understanding": not config.get("drop_understanding")}
    model_path = config.get("model_path")
    if model_path:
        if not has_weights(model_path):
            raise FileNotFoundError(
                f"model_path={model_path!r} contains no *.safetensors. "
                "Refusing to substitute a random-init model for a requested "
                "checkpoint — fix the path, or unset model_path and set "
                "model_preset: <tiny|1b|7b> for an explicit random-init run.")
        from ospo_tpu_torch.models import weights

        print(f"# Loading Janus-Pro weights from {model_path}")
        return weights.load_janus(model_path, device=device, quantize=quantize,
                                  **parts)

    preset = config.get("model_preset")
    if not preset:
        raise ValueError(
            "Neither model_path nor model_preset is set. Set model_path to a "
            "Janus-Pro checkpoint, or model_preset: <tiny|1b|7b> for an "
            "explicit random-init run.")
    seed = config.get("seed")
    if isinstance(seed, (list, tuple)):
        seed = seed[0] if seed else None
    seed = 42 if seed is None else int(seed)
    if preset in PRESETS:
        cfg = PRESETS[preset]
    elif preset == "tiny":
        cfg = janus_lib.tiny_janus_config()
    else:
        raise ValueError(f"unknown model_preset {preset!r} "
                         f"(expected tiny | {' | '.join(PRESETS)})")
    print(f"# Random-init preset '{preset}' on {device} (explicit model_preset).")
    return janus_lib.JanusModel.init(cfg, seed=seed, quantize=quantize,
                                     device=device, **parts)


def get_model(config) -> Tuple[janus_lib.JanusModel, object, Processor]:
    """→ (JanusModel, tokenizer, Processor)."""
    qmode = _validate_quantize_mode(config)
    _reject_unported(config)
    ckpt_path = config.get("ckpt_path")
    if ckpt_path:
        from ospo_tpu_torch.train.checkpoint import (checkpoint_mode,
                                                     merge_lora_checkpoint,
                                                     resolve_checkpoint_dir)

        ckpt_path = resolve_checkpoint_dir(ckpt_path)  # fail before the build
    if qmode:
        kind = {"int8": "W8A16", "w8a8": "W8A8"}.get(qmode, "W4A16")
        print(f"# Quantizing language-model weights to {qmode} ({kind}).")
    # a random-init or loaded trunk is quantized layer by layer as it is
    # built, unless adapters are merged into it first
    model = build_model(config, quantize="" if ckpt_path else qmode)
    if ckpt_path:
        mode = checkpoint_mode(ckpt_path)
        print(f"# Merging {'LoRA' if mode == 'lora' else 'full fine-tune'} "
              f"checkpoint {ckpt_path} into base weights.")
        merge_lora_checkpoint(model, ckpt_path)
        if qmode:
            quant.quantize_layers(model.params["language_model"]["layers"],
                                  qmode)
    model_path = config.get("model_path")
    tokenizer = load_tokenizer(model_path if has_weights(model_path) else None,
                               vocab_size=model.cfg.language.vocab_size)
    image_processor = load_image_processor(
        model_path if has_weights(model_path) else None,
        image_size=model.cfg.image_size)
    tp = int(config.get("tensor_parallel") or 1)
    if tp > 1:
        from ospo_tpu_torch.parallel import mesh as mesh_lib

        janus_lib.refuse_own_trunk(model, f"tensor parallel (tensor_parallel {tp})")

        mesh = mesh_lib.create_mesh(tp)
        print(f"# Sharding params over mesh {mesh.shape} (model rank "
              f"{mesh.model_rank} of data index {mesh.data_index}).")
        model.params = mesh_lib.shard_janus_params(model.params, mesh)
    return model, tokenizer, Processor(
        tokenizer, image_processor, num_image_tokens=model.cfg.num_image_tokens)
