"""Step 5: SimPO training of LoRA adapters through the program's
``SimPOTrainer.fit``.

Set-up builds the model and one trainer, hands it adapters drawn from the
seed (A uniform in ±1/√d_in, B zero), and starts ``fit`` over a dataset
of the program's own ``PreferenceDataset`` kind whose records the benchmark
made: a prompt and a chosen and a rejected 384² PNG from a seeded pool
under the run's scratch directory.  The first ``checked_steps`` updates of
that same call are the set-up (they build, warm up, and are what the
reference follows); the window opens when the last of them ends and takes
every update that ends within ``--seconds`` of it.  ``fit`` writes its
checkpoint when it returns, after the window.

The benchmark watches the trainer through its public state: the list of
update times (one append an update), ``logged`` (each step's scalars while
``log_steps`` is 1), the optimizer's moments and the adapters.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from harness.cell import Cell, prompt_text
from harness.images import write_pool
from harness.port import load_model, processor_for
from harness.weights import make_weights
from reference import janus as ref
from reference import png
from reference import train as ref_train
from reference.tokens import t2i_ids

PARTS = ("language", "generation")
TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def lora_widths(cfg: dict) -> Dict[str, tuple]:
    lc = cfg["language_config"]
    d, f = lc["hidden_size"], lc["intermediate_size"]
    kvd = (lc.get("num_key_value_heads") or lc["num_attention_heads"]) * (
        d // lc["num_attention_heads"])
    return {"q_proj": (d, d), "k_proj": (d, kvd), "v_proj": (d, kvd), "o_proj": (d, d),
            "gate_proj": (d, f), "up_proj": (d, f), "down_proj": (f, d)}


def init_adapters(cfg: dict, rank: int, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """A [L, d_in, r] uniform in ±1/√d_in, B [L, r, d_out] zero, fp32."""
    n = cfg["language_config"]["num_hidden_layers"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out = {}
    for name in TARGETS:
        d_in, d_out = lora_widths(cfg)[name]
        a = torch.empty((n, d_in, rank), device=device)
        a.uniform_(-d_in ** -0.5, d_in ** -0.5, generator=gen)
        out[name] = {"a": a, "b": torch.zeros((n, rank, d_out), device=device)}
    return out


class Driver:
    def __init__(self, cell: Cell):
        self.cell = cell
        self.t = cell.traffic
        self.batch = int(self.t["batch_size"])
        self.k = int(self.t["checked_steps"])
        self.seed31 = cell.seed % (1 << 31)
        self.snap: Dict[str, dict] = {}

    # ------------------------------------------------------------------
    def _records(self) -> List[dict]:
        t, cell = self.t, self.cell
        rng = cell.rng("records")
        side = cell.config["gen_vision_config"]["params"]["image_size"]
        paths = write_pool(os.path.join(cell.scratch, "pool"), int(t["image_pool"]), side,
                           cell.seed, cell.device)
        recs = []
        for i in range(self.batch * int(t["max_updates"])):
            c, r = rng.sample(range(len(paths)), 2)
            recs.append({"item_id": f"r{i}", "prompt": prompt_text(
                rng, rng.choice(t["prompt_tokens"])), "chosen": paths[c], "rejected": paths[r]})
        return recs

    def _trainer_config(self):
        from ospo_tpu_torch.config import Config

        c = copy.deepcopy(self.t["trainer"])
        c["experiment"]["seed"] = self.seed31
        c["base"] = {"save_path": os.path.join(self.cell.scratch, "ckpt"), "exp_name": "bench"}
        return Config.from_nested(c)

    def setup(self) -> None:
        from ospo_tpu_torch.pipeline.datasets import PreferenceDataset
        from ospo_tpu_torch.train.trainer import SimPOTrainer

        cell, t = self.cell, self.t
        weights = make_weights(cell.config, PARTS, cell.seed, cell.device)
        self.model = load_model(cell.config, weights, cell.scratch, cell.device,
                                quantize="")
        del weights
        self.processor = processor_for(self.model, cell.config)
        self.records = self._records()
        n = max(len(t2i_ids(r["prompt"])) for r in self.records)
        self.t_pad = max(32, -(-n // 32) * 32)   # the trainer's run-level text bucket
        data_path = os.path.join(cell.scratch, "train.json")
        with open(data_path, "w") as f:
            json.dump(self.records, f)
        driver = self

        class WindowDataset(PreferenceDataset):
            """The records in the benchmark's order, one batch an update,
            until the trainer is told to stop."""

            def iter_batches(self, batch_size, shuffle=True, seed=0, part=(0, 1)):
                for i in range(0, len(self.dataset) - batch_size + 1, batch_size):
                    yield [self[j] for j in range(i, i + batch_size)]

        self.dataset = WindowDataset(seed=self.seed31, data_path=data_path,
                                     processor=self.processor)
        self.trainer = SimPOTrainer(self._trainer_config(), self.model, self.processor)
        self.init = init_adapters(cell.config, int(t["trainer"]["lora"]["lora_rank"]),
                                  cell.seed + 1, cell.device)
        with torch.no_grad():
            for name, ab in self.trainer.trainable.items():
                for key, leaf in ab.items():
                    leaf.copy_(self.init[name][key])
        self.log_steps = self.trainer.log_steps
        self.trainer.log_steps = 1

        class Updates(list):
            def append(self, value):
                super().append(value)
                driver._on_update()

        self.trainer.update_seconds = Updates()
        self.t_w0 = self.t_end = None
        self.step_w0 = self.step_end = None
        self.seconds = None
        # fit runs on, through set-up into the window; window() waits for it
        self.error = None

        def fit():
            try:
                self.trainer.fit(self.dataset, batch_size=self.batch, max_epochs=1)
            except BaseException as e:  # reported by window()
                self.error = e
            finally:
                self._done.set()

        self._setup_done = threading.Event()
        self._go = threading.Event()
        self._done = threading.Event()
        self.thread = threading.Thread(target=fit, name="fit")
        self.thread.start()
        while not self._setup_done.wait(0.5):
            if self._done.is_set():
                self.thread.join()
                raise self.error or RuntimeError(
                    f"fit ended before update {self.k}")

    def _on_update(self) -> None:
        tr, step = self.trainer, self.trainer.global_step
        if step == 1:
            self.snap["mu1"] = {k: v.detach().clone() for k, v in tr.opt.mu.items()}
        if step == self.k:
            self.snap["after"] = {f"{n}/{k}": t.detach().clone()
                                  for n, ab in tr.trainable.items() for k, t in ab.items()}
            self._setup_done.set()
            self._go.wait()
            self.t_w0 = time.perf_counter()
            self.step_w0 = step
            return
        if step < self.k:
            return
        if step == self.k + 1:
            tr.log_steps = self.log_steps
        tracer = self.cell.record.tracer
        if self.t_end is not None:
            # after the window: one update profiled with CUDA activity, the
            # next with host ops too
            if step == self.step_end + 1:
                tracer.stop()
                tracer.start(host_ops=True)
            else:
                tracer.stop()
            return
        if time.perf_counter() - self.t_w0 >= self.seconds:
            self.t_end = time.perf_counter()
            self.step_end = step
            tr.max_steps = step + (2 if self.cell.trace else 0)
            if self.cell.trace:
                tracer.start()

    # ------------------------------------------------------------------
    def window(self, seconds: float) -> Dict[str, float]:
        self.seconds = seconds
        self._go.set()
        self._done.wait()
        self.thread.join()
        if self.error is not None:
            raise self.error
        rec = self.cell.record
        if self.t_end is None:
            raise RuntimeError("the records ran out before the window closed")
        rec.window = (self.t_w0, self.t_end)
        updates = self.step_end - self.step_w0
        lc = self.model.cfg.language
        seq = self.t_pad + self.model.cfg.num_gen_tokens
        rec.counters.update(updates=updates)
        rec.work.update(
            stage="step5", rows=2 * self.batch, seq=seq, layers=lc.num_layers,
            hidden=lc.hidden_size, ffn=lc.intermediate_size, heads=lc.num_heads,
            kv_heads=lc.kv_heads, head_dim=lc.dim_head,
            image_vocab=self.model.cfg.image_token_size,
            lora_rank=int(self.t["trainer"]["lora"]["lora_rank"]),
            lora_widths=sum(a + b for a, b in lora_widths(self.cell.config).values()),
            updates=updates, idle_unit_s=rec.window_s / updates, traced_units=1)
        pairs = updates * self.batch
        return {"train_pairs_per_s": pairs / rec.window_s, "attempted": pairs, "failed": 0}

    def release(self) -> None:
        self.logged = [dict(m) for m in self.trainer.logged[:self.k]]
        self.update_s = list(self.trainer.update_seconds)
        self.snap = {k: {p: t.cpu() for p, t in v.items()} for k, v in self.snap.items()}
        del self.trainer, self.model, self.dataset
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def reference_batches(self, w, processor_cfg) -> List[dict]:
        """The first ``checked_steps`` batches, worked out from the records."""
        cell = self.cell
        vq = cell.config["gen_vision_config"]["params"]["vq"]
        mean = torch.tensor(processor_cfg["image_mean"], device=cell.device)
        std = torch.tensor(processor_cfg["image_std"], device=cell.device)
        out = []
        for i in range(self.k):
            rows = self.records[i * self.batch:(i + 1) * self.batch]
            ids = [t2i_ids(r["prompt"]) for r in rows]
            text_ids = torch.zeros((len(rows), self.t_pad), dtype=torch.long)
            mask = torch.zeros((len(rows), self.t_pad))
            for j, x in enumerate(ids):
                text_ids[j, :len(x)] = torch.tensor(x)
                mask[j, :len(x)] = 1.0
            pix = np.stack([png.read(r[key]) for key in ("chosen", "rejected") for r in rows])
            x = torch.as_tensor(pix, device=cell.device).float() * processor_cfg["rescale_factor"]
            img_ids = ref.vq_encode(w, vq, (x - mean) / std)
            out.append({"text_ids": text_ids.to(cell.device), "text_mask": mask.to(cell.device),
                        "img_ids": img_ids})
        return out

    def hyper(self) -> dict:
        tr = self.t["trainer"]
        lora, opt, algo = tr["lora"], tr["optimizer"], tr["algo"]
        return {"scaling": lora["lora_alpha"] / lora["lora_rank"],
                "dropout": lora["lora_dropout"], "beta": algo["beta"],
                "gamma_beta_ratio": algo["gamma_beta_ratio"],
                "betas": tuple(opt["betas"]), "eps": opt["eps"], "lr": opt["init_lr"],
                "clip": tr["experiment"]["gradient_clip_val"]}

    def reference(self) -> dict:
        """The reference's first ``checked_steps`` updates from the same
        weights, records and adapters."""
        cell = self.cell
        w = make_weights(cell.config, PARTS, cell.seed, cell.device)
        with ref.full_fp32():
            batches = self.reference_batches(w, cell.config["preprocessor_config"])
            return ref_train.train(w, cell.config, batches, self.init, self.hyper(),
                                   self.seed31)

    def check(self) -> List[dict]:
        return self.compare(self.reference())

    def compare(self, out: dict) -> List[dict]:
        cell = self.cell
        b1 = self.hyper()["betas"][0]
        grads_sum = {p: sum(float(st[p.split('/')[0]][p.split('/')[1]].norm())
                            for st in out["grads"]) for p in ref_train.flat(self.init)}
        med = sorted(grads_sum.values())[len(grads_sum) // 2]
        quiet = {p for p, g in grads_sum.items() if g < 1e-3 * med}
        g1_ref = ref_train.flat(out["grad1"])
        g1_quiet = {p for p, g in g1_ref.items() if float(g.norm()) < 1e-3 * sorted(
            float(x.norm()) for x in g1_ref.values())[len(g1_ref) // 2]}
        g1_prog = {p: t.to(cell.device) / (1 - b1) for p, t in self.snap["mu1"].items()}
        init = ref_train.flat(self.init)
        d_ref = {p: t - init[p] for p, t in ref_train.flat(out["after"]).items()}
        d_prog = {p: t.to(cell.device) - init[p] for p, t in self.snap["after"].items()}
        lim = self.t["limits"]
        self.notes = [f"update seconds: {[round(x, 4) for x in self.update_s]}",
                      f"losses program {[m['loss'] for m in self.logged]} "
                      f"reference {out['loss']}",
                      f"grad norms program {[m['grad_norm'] for m in self.logged]} "
                      f"reference {out['grad_norm']}"]
        self.readings = {"ref_loss": out["loss"], "ref_grad_norm": out["grad_norm"],
                         "prog_loss": [m["loss"] for m in self.logged],
                         "prog_grad_norm": [m["grad_norm"] for m in self.logged],
                         "quiet": sorted(quiet), "grad1_quiet": sorted(g1_quiet)}
        # each update's loss is reported, not compared: no control or fault
        # moves it past what sound runs read (benchmark PERF.md, step 5)
        self.notes.append("loss gaps " + " ".join(
            f"{abs(float(m['loss']) - r):.6g}" for m, r in zip(self.logged, out["loss"])))
        return [
                {"name": "grad1_leaf_gap",
                 "value": ref_train.leaf_gaps(g1_prog, g1_ref, g1_quiet),
                 "limit": lim["grad1_leaf_gap"]},
                {"name": "update_leaf_gap",
                 "value": ref_train.leaf_gaps(d_prog, d_ref, quiet),
                 "limit": lim["update_leaf_gap"]},
                {"name": "grad1_leaf_diff",
                 "value": ref_train.leaf_diffs(g1_prog, g1_ref, g1_quiet),
                 "limit": lim["grad1_leaf_diff"]}]
