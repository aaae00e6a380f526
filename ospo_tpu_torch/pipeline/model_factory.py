"""Model/tokenizer/processor factory for the port's pipeline steps —
counterpart of ``ospo_tpu/pipeline/model_factory.py``.

Resolution (fail-fast, as in the JAX package):

1. ``model_path`` set → it must hold ``*.safetensors``; the generation side
   is loaded (``models/weights.load_janus``);
2. else ``model_preset`` (``tiny`` | ``1b`` | ``7b``) → random init;
3. neither → error.

The model lives on ``config.device`` (default ``cuda``; ``cpu`` only when
asked).  ``quantize: int8`` gives an int8 trunk; ``drop_lm_head`` and
``drop_understanding`` are honoured by never building those parts (the port
builds neither in this slice).
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

from ospo_tpu_torch.models import janus as janus_lib
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
    """'' (model dtype) or 'int8'; other modes are not ported yet, and an
    unknown spelling is an error before the (long) model build."""
    qmode = str(config.get("quantize") or "").lower()
    if qmode in ("", "none", "false", "bf16"):
        return ""
    if qmode == "int8":
        return qmode
    if qmode in ("w8a8", "int4", "int4g", "int4n"):
        raise NotImplementedError(
            f"quantize: {qmode} is queued in ROADMAP.md (slice 5, opt-in "
            "modes); the port serves int8 or unquantized weights")
    raise ValueError(
        f"unrecognized quantize value {config.get('quantize')!r}: use int8, "
        "w8a8, int4, int4g, int4n, or unset/none/bf16")


def _reject_unported(config) -> None:
    if config.get("ckpt_path"):
        raise NotImplementedError(
            "ckpt_path (LoRA merge) is queued in ROADMAP.md (slice 4, "
            "training)")
    if int(config.get("tensor_parallel") or 1) > 1 \
            or int(config.get("data_parallel") or 0) > 1 \
            or config.get("mesh_scope"):
        raise NotImplementedError(
            "tensor_parallel / data_parallel / mesh_scope (multi-GPU) are "
            "queued in ROADMAP.md (slice 5, scale-out)")


def build_model(config, quantize: bool = False) -> janus_lib.JanusModel:
    device = resolve_device(config.get("device"))
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
        return weights.load_janus(model_path, device=device, quantize=quantize)

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
                                     device=device)


def get_model(config) -> Tuple[janus_lib.JanusModel, object, Processor]:
    """→ (JanusModel, tokenizer, Processor)."""
    qmode = _validate_quantize_mode(config)
    _reject_unported(config)
    if qmode:
        print("# Quantizing language-model weights to int8 (W8A16).")
    model = build_model(config, quantize=bool(qmode))
    model_path = config.get("model_path")
    tokenizer = load_tokenizer(model_path if has_weights(model_path) else None,
                               vocab_size=model.cfg.language.vocab_size)
    return model, tokenizer, Processor(tokenizer)
