"""Step 3 on a Janus-Pro model whose trunk is quantized to group-wise int4
(``quantize: int4g``): ``drivers/step3.py``'s set-up, groups and readings,
with a check whose reference reads the weights the program computes with.

``drivers/step3.py`` holds the served tokens to a reference on int8
weights, which a group-wise int4 trunk departs from by far more than its
limit.  Here the reference (``reference/janus.py``'s ``cfg_logits``, its own
weight rounding off) is handed every trunk projection rounded exactly as
the program's ``int4g`` rounds it (``reference/int4g.py``, groups of the
traffic's ``int4_group`` input columns); the cache is read as the traffic's
int8 ``shbd`` KV.  The control reads the same positions with per-row int4
weights (what ``quantize: int4`` computes with), and the PNGs of a TF32
decode.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
from typing import List

import numpy as np
import torch

from reference import int4g
from reference import janus as ref
from reference import png
from reference.tokens import t2i_ids, uncond_ids

# drivers/step3.py, loaded by path into a module of this driver's own
_spec = importlib.util.spec_from_file_location(
    "drivers_step3_int4g_base",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "step3.py"))
step3 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(step3)

PARTS = step3.PARTS


class Driver(step3.Driver):
    def window(self, seconds: float):
        out = super().window(seconds)
        # a trunk parameter's bytes: half a byte of payload and its share of
        # the fp32 scale of its group
        group = int(self.t["int4_group"])
        self.cell.record.work.update(weight_bytes=0.5 + 4 / group, int4_group=group)
        return out

    def check(self, control: bool = False) -> List[dict]:
        """The numbers compared, each with its limit: every row of every
        greedy group held to the group-wise int4 reference's logits, every
        PNG to the reference's pixels of its served tokens.  ``control``:
        also the per-row int4 reference's reading of the same positions
        (``control_int4_row_gap``) and the pixels of a TF32 decode."""
        cell, t = self.cell, self.t
        cfg = cell.config
        vq = cfg["gen_vision_config"]["params"]["vq"]
        w = step3.make_weights(cfg, PARTS, cell.seed, cell.device)
        w4 = int4g.weights(w, cfg, int(t["int4_group"]))
        gaps, ctrl_gaps, pix, ctrl_pix = [], [], [], []
        cfg_w = float(t["cfg_weight"])
        with ref.full_fp32():
            for g in self.groups:
                served = g["tokens"][:len(g["prompts"])].to(cell.device)
                if g["greedy"]:
                    rows = [(t2i_ids(p), uncond_ids(t2i_ids(p)), served[r])
                            for r, p in enumerate(g["prompts"])]
                    logits = ref.cfg_logits(w4, cfg, rows, cfg_w, None, 127)
                    gaps += [ref.served_gap(lg, served[r]) for r, lg in enumerate(logits)]
                    if control:
                        low = ref.cfg_logits(w, cfg, rows, cfg_w, 7, 127)
                        ctrl_gaps += [ref.served_gap(lg, lo.argmax(-1))
                                      for lg, lo in zip(logits, low)]
                        del low
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
            out += [{"name": "control_int4_row_gap", "value": max(ctrl_gaps)},
                    {"name": "control_png_mean_abs", "value": max(ctrl_pix)}]
        return out
