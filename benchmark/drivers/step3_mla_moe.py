"""Step 3 on a Janus model with a DeepSeek-V2 trunk (MLA, routed experts):
``drivers/step3.py``'s set-up and groups through ``pipeline/step3.run_step3``,
with this trunk's weights, its reference and the shapes its readers need.

The traffic is ``step3``'s; the latent cache is the model's dtype
(``kv_quant`` false).  ``check`` holds the greedy groups' served tokens to
``reference/deepseek_v2.py``'s fused CFG logits and every PNG to the
reference's VQ decode; its controls read the same positions with int4
routed experts, with int4 weights throughout and with the top-k weights
renormalised.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
from typing import Dict, List

import numpy as np

from harness.weights_deepseek_v2 import make_weights
from reference import deepseek_v2 as ref_v2
from reference import janus as ref
from reference import png
from reference.tokens import t2i_ids, uncond_ids

# drivers/step3.py, loaded by path into a module of this driver's own, whose
# set-up then makes this trunk's weights
_spec = importlib.util.spec_from_file_location(
    "drivers_step3_base", os.path.join(os.path.dirname(os.path.abspath(__file__)), "step3.py"))
step3 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(step3)
step3.make_weights = make_weights

PARTS = step3.PARTS


class Driver(step3.Driver):
    def window(self, seconds: float) -> Dict[str, float]:
        out = super().window(seconds)
        lc = self.cell.config["language_config"]
        mc = self.model.cfg
        self.cell.record.work.update(
            trunk="mla_moe", experts=lc["n_routed_experts"],
            top_k=lc["num_experts_per_tok"], moe_layers=mc.language.n_moe,
            dense_layers=mc.language.n_dense, dense_ffn=lc["intermediate_size"],
            expert_ffn=lc["moe_intermediate_size"],
            shared_experts=lc.get("n_shared_experts", 0),
            shared_ffn=lc["moe_intermediate_size"] * lc.get("n_shared_experts", 0),
            q_head_dim=lc["qk_nope_head_dim"] + lc["qk_rope_head_dim"],
            v_head_dim=lc["v_head_dim"], kv_lora_rank=lc["kv_lora_rank"],
            rope_dim=lc["qk_rope_head_dim"], latent_bytes=2)
        return out

    # ------------------------------------------------------------------
    def check(self, control: bool = False) -> List[dict]:
        """As ``drivers/step3.py``'s, against ``reference/deepseek_v2.py``.
        ``control``: also the gaps of the same positions read with int4
        routed experts (``control_logit_gap``), with every projection and
        expert at int4, the nearest precision below the configuration's int8
        (``control_int4_all_gap``), and with the top-k weights renormalised
        (``control_renorm_gap``)."""
        cell, t = self.cell, self.t
        cfg = cell.config
        vq = cfg["gen_vision_config"]["params"]["vq"]
        w = make_weights(cfg, PARTS, cell.seed, cell.device)
        gaps, int4_gaps, int4_all_gaps, renorm_gaps, pix = [], [], [], [], []
        cfg_w = float(t["cfg_weight"])
        with ref.full_fp32():
            for g in self.groups:
                served = g["tokens"][:len(g["prompts"])].to(cell.device)
                if g["greedy"]:
                    rows = [(t2i_ids(p), uncond_ids(t2i_ids(p)), served[r])
                            for r, p in enumerate(g["prompts"])]
                    logits = ref_v2.cfg_logits(w, cfg, rows, cfg_w, 127)
                    gaps += [ref.served_gap(lg, served[r]) for r, lg in enumerate(logits)]
                    if control:
                        for dst, levels, kw in ((int4_gaps, 127, {"expert_levels": 7}),
                                                (int4_all_gaps, 7, {}),
                                                (renorm_gaps, 127, {"norm_topk": True})):
                            low = ref_v2.cfg_logits(w, cfg, rows, cfg_w, levels, **kw)
                            dst += [ref.served_gap(lg, lo.argmax(-1))
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
            out += [{"name": "control_logit_gap", "value": max(int4_gaps)},
                    {"name": "control_int4_all_gap", "value": max(int4_all_gaps)},
                    {"name": "control_renorm_gap", "value": max(renorm_gaps)}]
        return out
