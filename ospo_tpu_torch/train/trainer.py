"""SimPO trainer (step 5) — counterpart of ``ospo_tpu/train/trainer.py``
(:71-533).

One step does what the JAX package's ``_jit_step`` does (:289-350):

  uint8 pixels → normalize → VQ encode to 576 ids each (no grad)
  → text embeds zeroed at padding, stacked for chosen and rejected
  → gen-aligner image embeds → all-ones mask, ``arange`` positions
  → 2B trunk forward with LoRA (remat) → gen-head logits
  → labels −100 on text, image ids after it → SimPO loss
  → gradients of the trained tree → grad_norm (before clipping) → AdamW.

The trained tree is the LoRA adapters (``use_peft``, the default), or
with ``use_peft: False`` the submodules the ``experiment.freeze`` matrix
leaves unfrozen (:190-204): the model's own tensors, trained in place in
the model's dtype with fp32 moments.  Their image tokens are data: the VQ
encode runs without gradients and the codebook's gradient is zeroed, as in
the JAX step (:341-346).  ``experiment.quantize_base: int8`` or ``w8a8``
(LoRA mode) quantizes the frozen trunk's projections before the adapters
are drawn (:149-189); their backward runs ``ops/quant._W8A16`` or the
straight-through ``ops/quant._W8A8``.

Text is right-padded, so the first image label is predicted from a
zero-embedded pad position when a prompt is shorter than the bucket — a
quirk of the reference kept as it is.

``fit`` pins one text bucket per run, counts optimizer updates in
``global_step``, saves every ``save_steps`` and at the end, and writes
``train_stats.json``.  Scalars go to ``scalars.jsonl`` in the log directory
(one JSON object per logged step, the JAX package's ``train/<name>`` tags)
instead of a TensorBoard writer.

Several processes (``ospo_tpu/train/trainer.py:206-240``; launch with
``scripts/run_multihost_torch.sh``): ``model.data_parallel`` x
``model.tensor_parallel`` = the processes, one card each, laid out by
``parallel/mesh.py`` (model rank ``rank % tp``, data index ``rank // tp``).

- Data parallel: every process walks the same seeded global batches and
  its data index takes its contiguous rows; the gradients of each
  micro-batch are averaged over the data group (one flat fp32 buffer,
  ``all_reduce``, ÷ dp) before ``grad_norm`` and the clip, so both see the
  global gradient — exact because the SimPO loss is a batch mean and every
  row has the same 576 image labels.  Each data index folds itself into
  the LoRA dropout seed, so with dropout its masks are independent of the
  other indices' but not those a single process draws for the same rows.
- Tensor parallel (the JAX trainer's ``shard_lora_params`` /
  ``shard_trainable_params`` under GSPMD): the ranks of a model group train
  the same rows on their shards of the model (``get_model`` cut them).  The
  trunk's collectives carry their gradients (``models/llama._train_layer``),
  every rank draws the whole adapter tree and keeps its shard
  (``mesh.lora_param_specs``), the adapters that are replicated but see
  only this rank's heads or columns (column-parallel A, row-parallel B)
  have their gradients summed over the model group, and the global norm of
  ``grad_norm`` and the clip sums each shard's squares over the group and
  counts each replicated leaf once.  A full fine-tune trains the model's
  shards in place, its moments per shard.  Model rank 0's image ids are
  every rank's.  ``quantize_base`` scales the row-parallel rows by their
  abs-max over the group, as the whole trunk's.

Logged metrics are averaged over the data group; rank 0 alone writes
checkpoints, ``scalars.jsonl``, ``train_stats.json`` and the saved config.
A checkpoint holds whole tensors (the shards and their moments gathered
over the model group), the file either package reads; ``resume`` cuts this
rank's shards from it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ospo_tpu_torch.config import save_config
from ospo_tpu_torch.constants import IGNORE_ID
from ospo_tpu_torch.io import process_count, process_index
from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import llama as llama_lib
from ospo_tpu_torch.models import vqgan
from ospo_tpu_torch.models.weights import map_tree
from ospo_tpu_torch.ops import quant
from ospo_tpu_torch.ops.pixels import normalize_pixels
from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.pipeline.datasets import PreferenceDataset
from ospo_tpu_torch.platform import object_group
from ospo_tpu_torch.train import checkpoint as ckpt_lib
from ospo_tpu_torch.train import lora as lora_lib
from ospo_tpu_torch.train.optim import AdamW, global_norm, leaves, make_schedule
from ospo_tpu_torch.train.simpo import SimPOConfig, loss_and_metrics
from ospo_tpu_torch.utils.prefetch import prefetch_iter
from ospo_tpu_torch.utils.profiling import span


def _bucket(n: int, step: int = 32) -> int:
    return max(step, ((n + step - 1) // step) * step)


def _parse_quantize_base(value):
    """``experiment.quantize_base`` → None | "int8" | "w8a8"; unknown
    spellings raise (``trainer.py:48-68``)."""
    if value is None or value is False:
        return None
    if value is True:
        return "int8"
    s = str(value).strip().lower()
    if s in ("", "none", "false", "bf16", "0", "off"):
        return None
    if s in ("true", "1", "on"):
        return "int8"
    if s in ("int8", "w8a8"):
        return s
    raise ValueError(
        f"unrecognized quantize_base value {value!r}: use int8, w8a8, "
        "true (= int8), or false/unset (bf16 trunk)")


class SimPOTrainer:
    def __init__(self, config, model: janus_lib.JanusModel, processor):
        janus_lib.refuse_own_trunk(model, "step 5 (SimPO training)")
        self.config = config
        self.model = model
        self.processor = processor
        self.device = model.device
        self._t_pad = None          # run-level text bucket, set by fit()

        algo = config.get("algo") or {}
        self.simpo_cfg = SimPOConfig(
            beta=float(algo.get("beta", 1.0)),
            gamma_beta_ratio=float(algo.get("gamma_beta_ratio", 0.0)),
            label_smoothing=float(algo.get("label_smoothing", 0.0)),
            sft_weight=float(algo.get("sft_weight", 0.0)),
            loss_type=algo.get("loss_type", "sigmoid"),
        )
        self.use_peft = bool(config.get("use_peft", True))
        lcfg = config.get("lora") or {}
        self.lora_cfg = lora_lib.LoraConfig(
            rank=int(lcfg.get("lora_rank", 32)),
            alpha=int(lcfg.get("lora_alpha", 64)),
            dropout=float(lcfg.get("lora_dropout", 0.05)),
            target_modules=tuple(lcfg.get("target_modules")
                                 or lora_lib.DEFAULT_TARGETS),
        )

        exp = config.get("experiment") or {}
        opt_cfg = config.get("optimizer") or {}
        qb_mode = _parse_quantize_base(exp.get("quantize_base"))
        # a group of any size, 1 included, averages the gradients
        self.grouped = dist.is_available() and dist.is_initialized()
        self.n_proc, self.rank = process_count(), process_index()
        self.is_main = self.rank == 0
        mcfg = config.get("model") or {}
        self.tp = int(mcfg.get("tensor_parallel") or 1)
        dp = int(mcfg.get("data_parallel") or 0)
        if self.n_proc > 1 and self.tp == 1 and not dp:
            raise ValueError(
                f"training in {self.n_proc} processes needs "
                f"model.data_parallel={self.n_proc}: each process takes its "
                "rows of the global batch (scripts/run_multihost_torch.sh)")
        self.dp = dp or self.n_proc // self.tp
        if self.dp * self.tp != self.n_proc:
            raise ValueError(
                f"model.data_parallel={dp} x model.tensor_parallel={self.tp} "
                f"must equal the {self.n_proc} training process(es), one a "
                "card (scripts/run_multihost_torch.sh)")
        self.mesh = mesh_lib.current_mesh() if self.tp > 1 else None
        if self.tp > 1 and mesh_lib.model_parallel_size() != self.tp:
            raise ValueError(
                f"model.tensor_parallel={self.tp} but the model is not "
                "sharded over model groups of that size: build it with "
                "get_model under the same setting")
        self.data_index = self.rank // self.tp
        # the data group: every rank of one model index (the world without
        # tensor parallel)
        self._data_group = self.mesh.data_group if self.mesh else None
        if self.n_proc > 1 and (mcfg.get("mesh_scope") or "global") != "global":
            raise ValueError(
                f"training in {self.n_proc} processes needs model.mesh_scope:"
                f" global (one batch over every process), got "
                f"{mcfg.get('mesh_scope')!r}: a local scope would train the "
                "whole batch in every process")
        self.max_steps = int(exp.get("max_training_steps") or 1000)
        self.save_steps = exp.get("save_steps")
        self.log_steps = int(exp.get("log_steps") or 10)
        self.grad_accum = int(exp.get("gradient_accumulation_steps") or 1)
        self.remat = bool(exp.get("gradient_checkpointing", True))
        self.seed = int(exp.get("seed", 42))
        # XLA-style attention by default, as in the JAX trainer; "flash"
        # runs the flash forward and backward kernels
        self.attn_impl = exp.get("attn_impl", "xla")

        self.init_lr = float(opt_cfg.get("init_lr", 4e-5))
        self._lr_fn = make_schedule(
            opt_cfg.get("scheduler_type", "constant"), self.init_lr,
            self.max_steps, float(exp.get("warmup_ratio") or 0.0),
            float(opt_cfg.get("min_lr") or 1e-6))
        self._opt_args = dict(
            betas=tuple(opt_cfg.get("betas", (0.9, 0.95))),
            eps=float(opt_cfg.get("eps") or 1e-8),
            weight_decay=float(opt_cfg.get("weight_decay") or 0.0),
            grad_clip=exp.get("gradient_clip_val", 1.0),
            accumulation_steps=self.grad_accum)

        base = config.get("base") or {}
        self.save_path = base.get("save_path") or "./checkpoints/simpo"
        self.log_dir = os.path.join(self.save_path,
                                    base.get("exp_name") or "ospo")

        if self.use_peft:
            if qb_mode:
                self._quantize_base(qb_mode)
            self._set_trainable(lora_lib.init_lora(
                model.cfg.language, self.lora_cfg, self.seed, self.device))
        else:
            freeze = dict(exp.get("freeze") or {})
            self.trainable_keys = sorted(
                k for k in model.params if not freeze.get(k, True))
            if not self.trainable_keys:
                raise ValueError("full-finetune mode with everything frozen")
            self.trainable = {k: model.params[k] for k in self.trainable_keys}
            specs = mesh_lib.janus_param_specs(model.params)
            self._set_axes({k: specs[k] for k in self.trainable_keys},
                           partial=False)
            for path, t in leaves(self.trainable):
                if not t.is_floating_point():
                    raise ValueError(
                        f"full fine-tune: {path} is {t.dtype}; a quantized "
                        "trunk cannot be trained (build it unquantized)")
                t.requires_grad_(True)
            self.opt = AdamW(self.trainable, self._lr_fn, norm=self._global_norm,
                             **self._opt_args)
        self.global_step = 0
        self.update_seconds: List[float] = []  # wall time of each update
        self.stats: Dict[str, float] = {}      # fit()'s train_stats.json
        self.logged: List[Dict[str, float]] = []  # metrics of logged steps

    def _quantize_base(self, mode: str) -> None:
        """The QLoRA-style frozen trunk: its projections to ``mode`` (int8 or
        w8a8), unless already quantized, then in the same mode or an error
        (``ospo_tpu/train/trainer.py:149-189``)."""
        layers = self.model.params["language_model"]["layers"]
        wq = layers["wq"]
        if isinstance(wq, dict):
            have = ("w8a8" if "sa" in wq
                    else "int8" if set(wq) == {"q", "s"} else "int4*")
            if have != mode:
                raise ValueError(
                    f"experiment.quantize_base={mode!r} but the model's "
                    f"trunk is already {have}-quantized — rebuild the model "
                    "unquantized (quantize: none) or align the two settings")
        if not isinstance(wq, dict):
            # a shard's input-cut (row-parallel) rows take the group's max
            cut = {n: mesh_lib.all_max_model for n, axis in
                   mesh_lib.llama_param_specs()["layers"].items()
                   if axis == 2} if self.tp > 1 else None
            quant.quantize_layers(layers, mode, cut)

    def _set_axes(self, specs, partial: bool) -> None:
        """The sharded axis of each trained leaf by path (``leaves``' keys),
        and the replicated leaves whose gradient is a partial sum over the
        model group (``partial``: the adapters)."""
        self._axes = dict(leaves(specs))
        self._partial = [p for p, a in self._axes.items()
                         if a is None] if partial and self.tp > 1 else []

    def _set_trainable(self, tree) -> None:
        """The LoRA adapters (fp32 leaves requiring grad; under tensor
        parallel this rank's shard of the whole tree) and a fresh optimizer
        over them."""
        self._set_axes(mesh_lib.lora_param_specs(tree), partial=True)
        self.trainable = {
            n: {k: self._shard(f"{n}/{k}", torch.as_tensor(
                t, dtype=torch.float32, device=self.device))
                .clone().requires_grad_(True) for k, t in ab.items()}
            for n, ab in tree.items()}
        self.opt = AdamW(self.trainable, self._lr_fn, norm=self._global_norm,
                         **self._opt_args)

    def _shard(self, path: str, t):
        """This rank's shard of the whole leaf ``t`` at ``path``."""
        if self.mesh is None:
            return t
        return mesh_lib.shard_leaf(t, self._axes[path], self.mesh, path)

    # ------------------------------------------------------------------
    # preprocessing (host): variable-length text → bucketed arrays
    # ------------------------------------------------------------------
    def collate(self, items: List[Dict]) -> Dict[str, np.ndarray]:
        t_max = self._t_pad or _bucket(
            max(len(it["text_tokens"]) for it in items))
        b = len(items)
        text_ids = np.zeros((b, t_max), np.int32)
        text_mask = np.zeros((b, t_max), np.float32)
        for i, it in enumerate(items):
            ids = it["text_tokens"]
            text_ids[i, : len(ids)] = ids       # right padding (train.py:237-239)
            text_mask[i, : len(ids)] = 1.0
        return {
            "text_ids": text_ids,
            "text_mask": text_mask,
            "chosen_pixels": np.stack([it["chosen_pixels"] for it in items]),
            "rejected_pixels": np.stack([it["rejected_pixels"] for it in items]),
        }

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------
    def loss_and_grads(self, text_ids, text_mask, chosen_pixels,
                       rejected_pixels, dropout_seed=None):
        """→ (loss, metrics, gradients of the trained tree) of one
        micro-batch."""
        cfg, params, dev = self.model.cfg, self.model.params, self.device
        as_dev = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
        text_ids = as_dev(text_ids).long()
        text_mask = as_dev(text_mask).float()
        b = text_ids.shape[0]
        with span("train.vq_encode", device=True), torch.no_grad():
            pixels = torch.cat([as_dev(chosen_pixels), as_dev(rejected_pixels)])
            pixels = normalize_pixels(pixels, self.processor.image_processor)
            img_ids = vqgan.encode_to_ids(params["gen_vision_model"], cfg.vq,
                                          pixels)                  # [2B, N]
            # the labels of a model group are one rank's, whatever the
            # replicated encoders' last bits do
            img_ids = mesh_lib.broadcast_model(img_ids.contiguous())
        with span("train.forward", device=True):
            text_embeds = janus_lib.embed_text(params, text_ids) * text_mask[..., None]
            text_2b = torch.cat([text_embeds, text_embeds])
            img_embeds = janus_lib.prepare_gen_img_embeds(params, cfg, img_ids)
            seq = torch.cat([text_2b.to(img_embeds.dtype), img_embeds], dim=1)
            t_total = seq.shape[1]
            attn = torch.ones((2 * b, t_total), dtype=torch.int32, device=dev)
            pos = torch.arange(t_total, device=dev).expand(2 * b, t_total)
            hidden, _ = llama_lib.forward(
                params["language_model"], cfg.language, seq, attn, pos,
                lora=self.trainable if self.use_peft else None,
                lora_scaling=self.lora_cfg.scaling,
                lora_dropout=self.lora_cfg.dropout if self.use_peft else 0.0,
                lora_dropout_seed=dropout_seed, remat=self.remat,
                attn_impl=self.attn_impl)
            logits = janus_lib.gen_logits(params, hidden)
            text_labels = torch.full((2 * b, text_ids.shape[1]), IGNORE_ID,
                                     dtype=torch.long, device=dev)
            labels = torch.cat([text_labels, img_ids.long()], dim=1)
            loss, metrics = loss_and_metrics(self.simpo_cfg, logits, labels)
        params_ = [t for _, t in leaves(self.trainable)]
        with span("train.backward", device=True):
            # a leaf the loss does not reach (the VQ model, lm_head) gets zeros
            flat = iter([torch.zeros_like(p) if g is None else g for p, g in zip(
                params_, torch.autograd.grad(loss, params_, allow_unused=True))])
            grads = map_tree(self.trainable, lambda *_: next(flat))
        if not self.use_peft and "gen_vision_model" in grads:
            # the codebook stays frozen when the VQ model trains
            # (train.py:161-168)
            grads["gen_vision_model"]["codebook"] = torch.zeros_like(
                grads["gen_vision_model"]["codebook"])
        return loss, metrics, grads

    def _step(self, text_ids, text_mask, chosen_pixels, rejected_pixels,
              dropout_seed=None) -> Dict[str, torch.Tensor]:
        """One micro-batch: gradients, grad_norm before clipping, and the
        optimizer (an update every ``gradient_accumulation_steps``).  Device
        spans (``utils/profiling.py``): ``train.vq_encode``,
        ``train.forward``, ``train.backward``, ``train.optimizer``; ``fit``
        opens ``train.update`` around an update's micro-batches."""
        _, metrics, grads = self.loss_and_grads(
            text_ids, text_mask, chosen_pixels, rejected_pixels, dropout_seed)
        with span("train.optimizer", device=True):
            grads = self._reduce_grads(grads)
            metrics["grad_norm"] = self._global_norm(grads)
            self.opt.step(self.trainable, grads)
        return metrics

    def _reduce_grads(self, grads):
        """A micro-batch's gradients as the whole model's: the adapters'
        partial sums (``_partial``) summed over the model group, then every
        leaf averaged over the data group; each a flat fp32 buffer, each
        leaf back in its dtype (the gradients themselves on one process)."""
        out = dict(leaves(grads))

        def reduce(paths, fn):
            buf = fn(torch.cat([out[p].reshape(-1).float() for p in paths]))
            for p, part in zip(paths, torch.split(
                    buf, [out[p].numel() for p in paths])):
                out[p] = part.view_as(out[p]).to(out[p].dtype)

        if self._partial:
            reduce(self._partial, mesh_lib.all_reduce_model)
        if self.grouped:
            reduce(list(out), self._data_mean)
        it = iter(out.values())
        return map_tree(grads, lambda *_: next(it))

    def _data_mean(self, buf: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(buf, group=self._data_group)
        return buf / self.dp

    def _global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares of the whole model's gradient
        (``optim.global_norm``): a shard's squares summed over the model
        group, a replicated leaf's counted once; the same on every rank."""
        if self.mesh is None:
            return global_norm(grads)
        sums = {True: [], False: []}
        for path, g in leaves(grads):
            sums[self._axes[path] is not None].append(
                (g.float() * g.float()).sum())
        zero = torch.zeros((), device=self.device)
        sharded = mesh_lib.all_reduce_model(sum(sums[True], zero))
        return torch.sqrt(sum(sums[False], zero) + sharded)

    def _group_metrics(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, float]:
        """The logged metrics, averaged over the process group."""
        names = sorted(metrics)
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in names])
        if self.grouped:
            vals = self._data_mean(vals)
        return dict(zip(names, vals.tolist()))

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------
    def _log_scalars(self, metrics: Dict[str, float]) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps({"step": self.global_step, **{
                f"train/{k}": v for k, v in metrics.items()}}) + "\n")

    def _state_axis(self, key: str):
        """The sharded axis of an optimizer-state entry (``mu/<path>``...;
        None for the counters and for keys of no trained leaf)."""
        part, _, path = key.partition("/")
        return self._axes.get(path) if part in ("mu", "nu", "acc") else None

    def resume(self, ckpt_path: str) -> None:
        """Load a checkpoint of whole tensors (either package's, written at
        any tensor parallel) and keep this rank's shards of it."""
        tree, lora_cfg, step, opt_flat = ckpt_lib.load_checkpoint(ckpt_path)
        if self.use_peft:
            self.lora_cfg = lora_cfg
            self._set_trainable(tree)
        else:
            if set(tree) != set(self.trainable):
                raise ValueError(f"{ckpt_path} trains {sorted(tree)}, this "
                                 f"run {sorted(self.trainable)}")
            if self.mesh is not None:
                tree = mesh_lib.shard_tree(tree, self.mesh.model_rank, self.tp)
            ckpt_lib.assign_tree(self.trainable, tree)
        if opt_flat is not None:
            if self.mesh is not None:
                opt_flat = {k: mesh_lib.shard_leaf(
                    v, self._state_axis(k), self.mesh, k)
                    for k, v in opt_flat.items()}
            self.opt.load_state_dict(opt_flat)
        self.global_step = step
        print(f"# Resumed from {ckpt_path} at step {step}.")

    def save(self) -> Optional[str]:
        """Rank 0 writes the checkpoint and returns its path (the other
        ranks None); under tensor parallel the model group of data index 0
        first gathers the trained tree and the optimizer state to whole
        tensors.  Every rank leaves after a barrier, so none reads a step
        directory before it exists."""
        path = None
        tree, opt = self.trainable, self.opt.state_dict()
        if self.mesh is not None and self.data_index == 0:
            whole = iter([mesh_lib.gather_model(t, self._axes[p])
                          for p, t in leaves(tree)])
            tree = map_tree(tree, lambda *_: next(whole))
            opt = {k: mesh_lib.gather_model(v, self._state_axis(k))
                   for k, v in opt.items()}
        if self.is_main:
            path = ckpt_lib.save_checkpoint(
                self.log_dir, self.global_step, tree, self.lora_cfg,
                opt_state=opt, mode="lora" if self.use_peft else "full")
            print(f"# Saved checkpoint: {path}")
        if self.grouped:
            dist.barrier(group=object_group())
        return path

    def fit(self, dataset: PreferenceDataset, batch_size: int,
            max_epochs: int = 1) -> Dict[str, float]:
        if self.is_main:
            save_config(self.log_dir, self.config)
        self._t_pad = _bucket(dataset.max_text_len())
        t0 = time.time()
        samples = 0
        first_update_s = None
        first_update_samples = 0
        # dropout seeds fold in the MICRO-batch index, so accumulation
        # micro-batches draw different masks, and under data parallel the
        # data index, so data indices draw independent masks
        micro = self.global_step * self.grad_accum
        update = None   # the open train.update span (utils/profiling.py)
        try:
            for epoch in range(max_epochs):
                if self.global_step >= self.max_steps:
                    break
                for batch_items, batch in prefetch_iter(dataset.iter_batches(
                        batch_size, shuffle=True, seed=self.seed + epoch,
                        part=(self.data_index, self.dp)), self.collate):
                    if self.global_step >= self.max_steps:
                        break
                    if micro % self.grad_accum == 0:  # an update's first micro-batch
                        t_step = time.time()
                        update = span("train.update", pairs=0).__enter__()
                    seed = llama_lib.fold_seed(self.seed, micro)
                    if self.dp > 1:
                        seed = llama_lib.fold_seed(seed, self.data_index)
                    metrics = self._step(
                        batch["text_ids"], batch["text_mask"],
                        batch["chosen_pixels"], batch["rejected_pixels"],
                        dropout_seed=seed)
                    micro += 1
                    samples += len(batch_items) * self.dp  # global rows
                    update.attrs["pairs"] += len(batch_items)
                    if micro % self.grad_accum:
                        continue  # accumulation micro-batch — no update yet
                    self.global_step += 1
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    update.__exit__(None, None, None)
                    update = None
                    self.update_seconds.append(time.time() - t_step)

                    if self.global_step % self.log_steps == 0 \
                            or self.global_step == 1:
                        metrics = self._group_metrics(metrics)
                        if first_update_s is None:
                            first_update_s = time.time() - t0
                            first_update_samples = samples
                        metrics["lr"] = self._lr_fn(self.global_step)
                        metrics["samples_per_sec"] = samples / (time.time() - t0)
                        self.logged.append(metrics)
                        if self.is_main:
                            self._log_scalars(metrics)
                            print(f"step {self.global_step}: loss="
                                  f"{metrics['loss']:.4f} acc="
                                  f"{metrics['rewards/accuracies']:.3f} margin="
                                  f"{metrics['rewards/margins']:.4f} "
                                  f"{metrics['samples_per_sec']:.2f} samples/s")

                    if self.save_steps and self.global_step % int(self.save_steps) == 0:
                        self.save()
        finally:   # a partial or failed update
            if update is not None:
                update.__exit__(None, None, None)
        self.save()
        total_s = time.time() - t0
        steady_s = total_s - (first_update_s or 0.0)
        steady_n = samples - first_update_samples
        self.stats = {
            "first_update_s": round(first_update_s or 0.0, 1),
            "total_s": round(total_s, 1),
            "samples": samples,
            "samples_per_s_wall": round(samples / total_s, 3)
            if total_s > 0 else 0.0,
            "samples_per_s_steady": round(steady_n / steady_s, 3)
            if steady_s > 0 and steady_n > 0 else None,
        }
        if self.is_main:
            try:
                with open(os.path.join(self.log_dir, "train_stats.json"),
                          "w") as f:
                    json.dump(self.stats, f, indent=1)
            except OSError as e:  # diagnostics, never fail training
                print(f"# train_stats.json not written: {e}")
        return self.logged[-1] if self.logged else {}
