"""Step 3: CFG image generation through ``pipeline/step3.run_step3``.

Each call of ``run_step3`` is one group: ``pairs`` items, each carrying
the prompt of one image slot (3 base + 3 negative; the slot, and with it
the seed of ``seed_list``, rotates from call to call), so a call decodes
``pairs`` CFG pairs (2·pairs rows), VQ-decodes them and writes their PNGs.
The loop is closed: a group starts when the last one's PNGs are written,
and a group started inside the window runs to its end.  Every
``greedy_every``-th group, the window's first among them, samples at
temperature 0 so that its tokens can be held to the reference's logits.

The benchmark sees the program through a subclass of its engine that keeps
the tokens handed to the VQ decode and times the engine calls.
"""

from __future__ import annotations

import gc
import os
import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from harness.cell import Cell, prompt_text
from harness.port import load_model, processor_for
from harness.weights import make_weights
from reference import janus as ref
from reference import png
from reference.tokens import t2i_ids, uncond_ids

PARTS = ("language", "generation")
SLOTS = 6


def _engine_class():
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine

    class WatchedEngine(ImageGenEngine):
        """The program's engine; keeps the tokens it decodes to pixels and
        the host span of each ``generate_images_device`` call."""

        def __init__(self, *args, spans=None, **kwargs):
            super().__init__(*args, **kwargs)
            self.decoded: List[torch.Tensor] = []
            self.spans = spans

        def _decode_tokens(self, gen_tokens):
            self.decoded.append(gen_tokens)
            return super()._decode_tokens(gen_tokens)

        def generate_images_device(self, prompts, seed=0):
            t0 = time.perf_counter()
            out = super().generate_images_device(prompts, seed=seed)
            if self.spans is not None:
                self.spans.append(("engine", t0, time.perf_counter()))
            return out

    return WatchedEngine


class Driver:
    def __init__(self, cell: Cell):
        self.cell = cell
        self.t = cell.traffic
        self.pairs = int(self.t["pairs"])
        rng = cell.rng("seeds")
        self.seed_list = [rng.randrange(1 << 31) for _ in range(3)]
        self.groups: List[dict] = []

    # ------------------------------------------------------------------
    def group_prompts(self, k: int) -> List[str]:
        rng = self.cell.rng(f"group{k}")
        return [prompt_text(rng, rng.choice(self.t["prompt_tokens"]))
                for _ in range(self.pairs)]

    def _items(self, k: int, prompts: List[str]) -> List[dict]:
        slot = k % SLOTS
        items = []
        for r, p in enumerate(prompts):
            base, neg = ["", "", ""], ["", "", ""]
            (base if slot < 3 else neg)[slot % 3] = p
            items.append({"item_id": f"g{k}r{r}", "category": "object",
                          "long_prompt": base, "negative_long_prompt": neg})
        return items

    def png_path(self, save_path: str, k: int, r: int) -> str:
        slot = k % SLOTS
        kind = "base" if slot < 3 else "negative"
        return os.path.join(save_path, kind, "object", f"g{k}r{r}",
                            f"{slot % 3:02d}.png")

    def _config(self, save_path: str):
        from ospo_tpu_torch.config import Config

        return Config.from_nested({"batch_size": self.pairs,
                                   "seed_list": self.seed_list,
                                   "save_path": save_path})

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from ospo_tpu_torch.models import vqgan

        cell, t = self.cell, self.t
        weights = make_weights(cell.config, PARTS, cell.seed, cell.device)
        self.model = load_model(cell.config, weights, cell.scratch, cell.device,
                                quantize=t["quantize"])
        del weights
        self.processor = processor_for(self.model, cell.config)
        mc = self.model.cfg
        kwargs = dict(cfg_weight=float(t["cfg_weight"]),
                      temperature=float(t["temperature"]),
                      patch_size=mc.vq.downsample_factor,
                      kv_quant=t["kv_quant"],
                      decode_segments=int(t["decode_segments"]),
                      kv_layout=t["kv_layout"], batch_cap=self.pairs)
        engine_cls = _engine_class()
        self.engine = engine_cls(self.model, self.processor,
                                 image_token_num=mc.num_gen_tokens,
                                 img_size=mc.gen_image_size,
                                 spans=cell.record.spans, **kwargs)
        # warm-up at the traffic's own batch and prompt buckets: a short
        # decode per bucket (4 tokens, a 2x2 latent) through run_step3, and
        # one VQ decode at the served size
        from ospo_tpu_torch.pipeline.step3 import run_step3

        warm = engine_cls(self.model, self.processor, image_token_num=4,
                          img_size=2 * mc.vq.downsample_factor, **kwargs)
        seen = set()
        for k in range(int(t["warm_groups"])):
            prompts = self.group_prompts(k)
            bucket = -(-max(len(t2i_ids(p)) for p in prompts) // 64)
            if bucket in seen:
                continue
            seen.add(bucket)
            run_step3(self._config(os.path.join(cell.scratch, "warm")), warm,
                      self.processor, self._items(k, prompts))
        side = mc.gen_image_size // mc.vq.downsample_factor
        vqgan.decode_code(self.model.params["gen_vision_model"], mc.vq,
                          torch.zeros((self.pairs, side * side), dtype=torch.long,
                                      device=cell.device))
        shutil.rmtree(os.path.join(cell.scratch, "warm"), ignore_errors=True)
        cell.sync()

    # ------------------------------------------------------------------
    def window(self, seconds: float) -> Dict[str, float]:
        from ospo_tpu_torch.pipeline.step3 import run_step3

        cell, rec = self.cell, self.cell.record
        hooks: List[float] = []
        if cell.trace:
            self.engine.step_hook = lambda step: hooks.append(time.perf_counter())
        every = int(self.t["greedy_every"])
        t0 = time.perf_counter()
        t_end = t0
        k = 0
        while t_end - t0 < seconds:
            prompts = self.group_prompts(k)
            greedy = k % every == 0
            self.engine.temperature = 0.0 if greedy else float(self.t["temperature"])
            save = os.path.join(cell.scratch, "step3", f"g{k}")
            hooks.clear()
            n_decoded = len(self.engine.decoded)
            stats = run_step3(self._config(save), self.engine, self.processor,
                              self._items(k, prompts))
            t_group = t_end
            t_end = time.perf_counter()
            self.groups.append({
                "k": k, "greedy": greedy, "prompts": prompts, "save": save,
                "written": stats["written"], "t_prompt": self._bucket(prompts),
                "seconds": t_end - t_group,
                "tokens": self.engine.decoded[n_decoded],
                "hook_span": (hooks[-1] - hooks[0], len(hooks) - 1) if len(hooks) > 1 else None})
            k += 1
        rec.window = (t0, t_end)
        mc = self.model.cfg
        lc = mc.language
        lo, hi = self.t["trace_steps"]
        traced_bucket = self._traced_group(k) if cell.trace else None
        rec.counters.update(groups=len(self.groups),
                            pairs_written=sum(g["written"] for g in self.groups))
        spans = [g["hook_span"] for g in self.groups if g["hook_span"]]
        rec.work.update(
            stage="step3", rows=2 * self.pairs, n_img=mc.num_gen_tokens,
            layers=lc.num_layers, hidden=lc.hidden_size,
            ffn=lc.intermediate_size, heads=lc.num_heads, kv_heads=lc.kv_heads,
            head_dim=lc.dim_head, image_vocab=mc.image_token_size,
            weight_bytes=1, kv_bytes=1,
            t_prompts=[g["t_prompt"] for g in self.groups],
            trace_cur_lens=[traced_bucket + s for s in range(lo, hi)] if traced_bucket else [],
            hook_spans=spans,
            # host seconds a decode step in the window, against which the
            # traced steps' device-busy time is read
            idle_unit_s=sum(s for s, _ in spans) / sum(n for _, n in spans) if spans else None,
            traced_units=hi - lo)
        tokens = sum(g["written"] for g in self.groups) * mc.num_gen_tokens
        return {"img_tok_per_s": tokens / rec.window_s,
                "attempted": len(self.groups) * self.pairs,
                "failed": len(self.groups) * self.pairs
                - sum(g["written"] for g in self.groups)}

    def _bucket(self, prompts: List[str]) -> int:
        return -(-max(len(t2i_ids(p)) for p in prompts) // 64) * 64

    def _traced_group(self, k: int) -> int:
        """One more group after the window: CUDA activity over decode steps
        ``trace_steps``, host ops too over ``host_trace_steps``; its images
        are not counted or checked.  → its prompt bucket."""
        from ospo_tpu_torch.pipeline.step3 import run_step3

        tracer = self.cell.record.tracer
        lo, hi = self.t["trace_steps"]
        hlo, hhi = self.t["host_trace_steps"]

        def hook(step):
            if step in (lo, hlo):
                tracer.start(host_ops=step == hlo)
            elif step in (hi, hhi):
                tracer.stop()

        prompts = self.group_prompts(k)
        self.engine.step_hook = hook
        self.engine.temperature = float(self.t["temperature"])
        run_step3(self._config(os.path.join(self.cell.scratch, "traced")), self.engine,
                  self.processor, self._items(k, prompts))
        tracer.stop()
        self.engine.step_hook = None
        return self._bucket(prompts)

    def release(self) -> None:
        for g in self.groups:
            g["tokens"] = g["tokens"].cpu()
        del self.engine, self.model
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def check(self, control: bool = False) -> List[dict]:
        """The numbers compared, each with its limit: every row of every
        greedy group held to the reference's logits, every PNG to the
        reference's pixels of its served tokens.  ``control``: also the int4
        reference's reading of the same positions (its gap), and the pixels
        of a TF32 decode."""
        cell, t = self.cell, self.t
        cfg = cell.config
        vq = cfg["gen_vision_config"]["params"]["vq"]
        w = make_weights(cfg, PARTS, cell.seed, cell.device)
        gaps, ctrl_gaps, pix, ctrl_pix = [], [], [], []
        cfg_w = float(t["cfg_weight"])
        with ref.full_fp32():
            for g in self.groups:
                served = g["tokens"][:len(g["prompts"])].to(cell.device)
                if g["greedy"]:
                    rows = [(t2i_ids(p), uncond_ids(t2i_ids(p)), served[r])
                            for r, p in enumerate(g["prompts"])]
                    logits = ref.cfg_logits(w, cfg, rows, cfg_w, 127, 127)
                    gaps += [ref.served_gap(lg, served[r]) for r, lg in enumerate(logits)]
                    if control:
                        low = ref.cfg_logits(w, cfg, rows, cfg_w, 7, 7)
                        ctrl_gaps += [ref.served_gap(lg, lo.argmax(-1))
                                      for lg, lo in zip(logits, low)]
                    del logits
                want = ref.vq_decode(w, vq, served).cpu().numpy().astype(np.int16)
                for r in range(len(g["prompts"])):
                    path = self.png_path(g["save"], g["k"], r)
                    if not os.path.exists(path):
                        pix.append(255.0)
                        continue
                    pix.append(float(np.abs(png.read(path).astype(np.int16) - want[r]).mean()))
                if control:
                    torch.backends.cudnn.allow_tf32 = True
                    torch.backends.cuda.matmul.allow_tf32 = True
                    low = ref.vq_decode(w, vq, served).cpu().numpy().astype(np.int16)
                    torch.backends.cudnn.allow_tf32 = False
                    torch.backends.cuda.matmul.allow_tf32 = False
                    ctrl_pix += [float(np.abs(lo - wa).mean()) for lo, wa in zip(low, want)]
        for g in self.groups:
            shutil.rmtree(g["save"], ignore_errors=True)
        self.notes = [f"group {g['k']}: {g['seconds']:.3f} s, prompt bucket {g['t_prompt']}, "
                      f"{'greedy' if g['greedy'] else 'sampled'}, {g['written']} written"
                      for g in self.groups]
        lim = t["limits"]
        out = [{"name": "logit_gap", "value": max(gaps) if gaps else float("inf"),
                "limit": lim["logit_gap"]},
               {"name": "png_mean_abs", "value": max(pix), "limit": lim["png_mean_abs"]}]
        if control:
            out += [{"name": "control_logit_gap", "value": max(ctrl_gaps)},
                    {"name": "control_png_mean_abs", "value": max(ctrl_pix)}]
        return out
