"""Step 5 — SimPO training on (prompt, chosen image, rejected image)
triples (counterpart of ``ospo_tpu/pipeline/step5.py``).

Loads ``train.json`` into a :class:`PreferenceDataset`, trains with
:class:`SimPOTrainer` — LoRA adapters (``use_peft: True``, optionally on
an int8 trunk with ``experiment.quantize_base``) or the submodules that
``experiment.freeze`` leaves unfrozen (``use_peft: False``) — checkpoints
every ``save_steps`` and at the end, and supports ``base.resume``.

Run: ``python -m ospo_tpu_torch.pipeline.step5 --cfg_path configs/step5.yaml
[key=value ...]`` (``device=cpu`` to run on the CPU).  In several processes
(``scripts/run_multihost_torch.sh N``): ``model.data_parallel`` and
``model.tensor_parallel``, whose product is N.
"""

from __future__ import annotations

import argparse
import os

from ospo_tpu_torch.config import Config, build_config
from ospo_tpu_torch.io import set_seed
from ospo_tpu_torch.pipeline.datasets import PreferenceDataset
from ospo_tpu_torch.pipeline.model_factory import get_model
from ospo_tpu_torch.platform import maybe_init_distributed
from ospo_tpu_torch.train.trainer import SimPOTrainer
from ospo_tpu_torch.utils.profiling import print_process_summary


def main(config) -> SimPOTrainer:
    """Train; returns the trainer (its ``stats``, ``update_seconds`` and
    adapters) for callers that inspect the run."""
    base = config.base or {}
    if base.get("save_path"):
        os.makedirs(base["save_path"], exist_ok=True)

    exp = config.experiment or {}
    # a blank `seed:` in YAML is a present None
    seed = exp.get("seed")
    seed = 42 if seed is None else int(seed)
    set_seed(seed)

    model_cfg = dict(config.model or {})
    model_cfg.setdefault("model_preset", config.get("model_preset"))
    model_cfg.setdefault("seed", seed)
    model_cfg.setdefault("device", config.get("device"))
    # the JAX step sets mesh_scope: global (one batch over every process);
    # the port accepts it on one device
    model_cfg.setdefault("mesh_scope", "global")
    model, _, processor = get_model(Config.from_nested(model_cfg))

    train_cfg = config.dataset.train
    dataset = PreferenceDataset(
        seed=int(exp.get("seed", 42)),
        data_path=train_cfg.data_path,
        processor=processor,
        num_samples=train_cfg.get("num_samples"),
    )
    # relocated step-3 image trees (train.json may carry foreign paths)
    dataset.data_root = config.get("image_root") or os.path.join(
        os.path.dirname(os.path.dirname(train_cfg.data_path)), "step3")
    print(f"Total length of data: {len(dataset)}")

    trainer = SimPOTrainer(config, model, processor)
    resume = base.get("resume")
    if resume and os.path.exists(resume):
        print("Training resume.")
        trainer.resume(resume)
    trainer.fit(dataset, batch_size=int(train_cfg.get("batch_size") or 16),
                max_epochs=int(exp.get("max_epochs") or 1))
    print("Training END.")
    print_process_summary("step5", {"global_step": trainer.global_step,
                                    "update_seconds": trainer.update_seconds})
    return trainer


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", type=str, default="configs/step5.yaml")
    args, _ = parser.parse_known_args()
    config = build_config(cfg_path=args.cfg_path)
    maybe_init_distributed(config.get("device"))
    main(config)
