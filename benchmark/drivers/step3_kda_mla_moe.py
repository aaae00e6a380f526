"""Step 3 on a Janus model with a Kimi Linear trunk (Kimi Delta Attention
beside NoPE latent attention, an expert share of sigmoid-routed experts):
``drivers/step3.py``'s set-up and groups through
``pipeline/step3.run_step3``, with this trunk's weights, its reference and
the shapes its readers need.

The traffic is ``step3``'s prompts at the traffic's own pairs a group; the
MLA layers' latent cache is the model's dtype (``kv_quant`` false), the KDA
recurrent state fp32.  ``check`` holds, on a seeded subset of
``check_pairs`` pairs of every greedy group, the served tokens to
``reference/kimi_linear.py``'s fused CFG logits (``logit_gap``) and the
program's recurrent states to the reference's (``kda_state_rel``), and
every PNG to the reference's VQ decode (``png_mean_abs``).

The states are read in a teacher-forced replay of those pairs through the
program's trunk (its prefill, then its T = 1 steps fed the served tokens,
eagerly, so that the host sees every KDA layer's step): each step of each
KDA layer, the reference's ``kda_step`` takes the projections the program
computed and advances a state of its own from the program's state after the
prefill; the reading is the largest relative distance (Frobenius, a row and
head) between the program's state and the reference's over every step.
The controls read the same positions with int4 weights throughout (logits),
with the reference's state rounded to bf16 after every step and with each
head decayed by one scalar, the mean of its per-channel g (states), and the
PNGs of a TF32 decode.
"""

from __future__ import annotations

import gc
import importlib.util
import os
import shutil
from typing import Dict, List

import numpy as np
import torch

from harness.program_spans import window_spans
from harness.weights_kimi_linear import make_weights
from reference import janus as ref
from reference import kimi_linear as ref_kl
from reference import png
from reference.tokens import t2i_ids, uncond_ids

# drivers/step3.py, loaded by path into a module of this driver's own, whose
# set-up then makes this trunk's weights
_spec = importlib.util.spec_from_file_location(
    "drivers_step3_kda_base",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "step3.py"))
step3 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(step3)
step3.make_weights = make_weights

PARTS = step3.PARTS


class Driver(step3.Driver):
    def window(self, seconds: float) -> Dict[str, float]:
        out = super().window(seconds)
        lc = self.cell.config["language_config"]
        la = lc["linear_attn_config"]
        mc = self.model.cfg.language
        rec = self.cell.record
        rows = rec.work["rows"]
        # the routed slots a row sends to the experts held here: the
        # window's decode steps' mean from the program's counters (routed
        # over all experts, 8 x 64 / 256 expected), what the expert readers
        # take as a row's top-k
        spans = window_spans(rec, "image.experts") or []
        routed = sum(s.attrs["routed_rows"] for s in spans)
        steps = sum(s.attrs["steps"] for s in spans)
        held_k = routed / (steps * mc.n_moe * rows) if steps else \
            lc["num_experts_per_token"] * mc.held / mc.experts
        rec.work.update(
            trunk="kda_mla_moe", experts=mc.held, routed_experts=mc.experts,
            top_k=held_k, router_top_k=lc["num_experts_per_token"],
            moe_layers=mc.n_moe, dense_layers=mc.n_dense, dense_ffn=lc["intermediate_size"],
            kda_layers=mc.n_kda, mla_layers=mc.n_mla,
            expert_ffn=lc["moe_intermediate_size"], shared_experts=mc.n_shared,
            shared_ffn=lc["moe_intermediate_size"] * mc.n_shared,
            kda_heads=la["num_heads"], kda_dim=la["head_dim"],
            conv_kernel=la["short_conv_kernel_size"], q_heads=lc["num_attention_heads"],
            q_head_dim=lc["qk_nope_head_dim"] + lc["qk_rope_head_dim"],
            v_head_dim=lc["v_head_dim"], kv_lora_rank=lc["kv_lora_rank"],
            rope_dim=lc["qk_rope_head_dim"], latent_bytes=2, state_bytes=4, conv_bytes=2)
        return out

    # ------------------------------------------------------------------
    def release(self) -> None:
        """The engine goes; the program's model stays for ``check``'s replay
        of the checked pairs, whose prompts are batched here."""
        for g in self.groups:
            g["tokens"] = g["tokens"].cpu()
            if g["greedy"]:
                g["pick"] = self._pick(g)
                g["batch"] = self.engine.build_cfg_batch([g["prompts"][r] for r in g["pick"]])
        del self.engine
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def _pick(self, g: dict) -> List[int]:
        n = len(g["prompts"])
        return sorted(self.cell.rng(f"check{g['k']}").sample(
            range(n), min(int(self.t["check_pairs"]), n)))

    def _replay_states(self, w, tokens: np.ndarray, mask: np.ndarray,
                       served: torch.Tensor):
        """The program's trunk teacher-forced on the CFG rows of ``tokens``,
        ``mask`` and the served image tokens ``served`` [pairs, n_img]
        (module docstring) → the largest relative distance of its KDA
        states from the reference's, and of the two controls'."""
        from ospo_tpu_torch.models import janus as janus_lib
        from ospo_tpu_torch.models import llama
        from ospo_tpu_torch.ops import gated_delta

        cfg, params, dev = self.model.cfg, self.model.params, self.cell.device
        lc = self.cell.config["language_config"]
        layers = ref_kl.kda_layers(w, lc)
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        mask = torch.as_tensor(mask, dtype=torch.int32, device=dev)
        rows, t_prompt = tokens.shape
        n_img = served.shape[1]
        s_max = t_prompt + n_img
        kv = janus_lib.init_kv_cache(params, cfg, rows, s_max, quantized=False,
                                     layout="shbd", device=dev)
        _, kv = janus_lib.language_forward(
            params, cfg, janus_lib.embed_text(params, tokens), mask,
            llama.positions_from_mask(mask), kv_cache=kv, self_attn=True)
        # the states the cached steps start from: the program's after the prefill
        state = kv["kda_state"]
        S_ref = state.clone()
        S_bf16, S_scalar = S_ref.to(torch.bfloat16).float(), S_ref.clone()
        conv = kv["conv_state"].to(torch.float32, copy=True)
        layer_of = {state[i].data_ptr(): i for i in range(state.shape[0])}
        seen = [None] * state.shape[0]        # each KDA layer's projections of a step
        worst = torch.zeros((3,), device=dev)

        def rel(a, b):
            return (torch.linalg.vector_norm(a - b, dim=(-2, -1))
                    / torch.linalg.vector_norm(b, dim=(-2, -1)).clamp_min(1e-30)).max()

        real = gated_delta.kda_decode

        def watched(q, k, v, f, b, og, conv_w, conv_state, layer_state, *rest):
            seen[layer_of[layer_state.data_ptr()]] = (torch.cat([q, k, v], -1), f, b)
            return real(q, k, v, f, b, og, conv_w, conv_state, layer_state, *rest)

        window = torch.cat([mask, torch.ones((rows, n_img), dtype=torch.int32,
                                             device=dev)], dim=1)
        prompt_len = mask.sum(dim=-1)
        served = served.to(dev)
        gated_delta.kda_decode = watched
        try:
            for step in range(1, n_img):
                tok = torch.cat([served[:, step - 1], served[:, step - 1]])
                embeds = janus_lib.prepare_gen_img_embeds(params, cfg, tok[:, None])
                _, kv = janus_lib.language_forward(
                    params, cfg, embeds, window, (prompt_len + step - 1)[:, None],
                    kv_cache=kv, attn_window=s_max)
                x, f, b = (torch.stack([s[i] for s in seen]) for i in range(3))
                S_bf16, _ = ref_kl.kda_step(lc, layers, x, f, b, conv, S_bf16, torch.bfloat16)
                S_scalar, _ = ref_kl.kda_step(lc, layers, x, f, b, conv, S_scalar,
                                              scalar_decay=True)
                S_ref, conv = ref_kl.kda_step(lc, layers, x, f, b, conv, S_ref)
                torch.maximum(worst, torch.stack([rel(state, S_ref), rel(S_bf16, S_ref),
                                                  rel(S_scalar, S_ref)]), out=worst)
        finally:
            gated_delta.kda_decode = real
        return worst.tolist()

    def check(self, control: bool = False) -> List[dict]:
        """As ``drivers/step3.py``'s, against ``reference/kimi_linear.py``,
        the logits and the recurrent states (module docstring) on
        ``check_pairs`` pairs of each greedy group drawn from the seed.
        ``control``: also the gaps of the same positions read with every
        projection and expert at int4, the nearest precision below the
        configuration's int8 (``control_int4_all_gap``), the states'
        distance with the reference's state rounded to bf16 after every
        step (``control_bf16_state_rel``) and with a scalar decay a head
        (``control_scalar_decay_state_rel``), and the pixels of a TF32
        decode (``control_png_mean_abs``)."""
        cell, t = self.cell, self.t
        cfg = cell.config
        vq = cfg["gen_vision_config"]["params"]["vq"]
        w = make_weights(cfg, PARTS, cell.seed, cell.device)
        gaps, int4_gaps, pix, ctrl_pix = [], [], [], []
        state_rel, ctrl_bf16, ctrl_scalar = 0.0, 0.0, 0.0
        cfg_w = float(t["cfg_weight"])
        with ref.full_fp32(), torch.inference_mode():
            for g in self.groups:
                if g["greedy"]:
                    got, bf, sc = self._replay_states(w, *g["batch"], g["tokens"][g["pick"]])
                    state_rel = max(state_rel, got)
                    ctrl_bf16, ctrl_scalar = max(ctrl_bf16, bf), max(ctrl_scalar, sc)
        del self.model
        gc.collect()
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        with ref.full_fp32():
            for g in self.groups:
                served = g["tokens"][:len(g["prompts"])].to(cell.device)
                if g["greedy"]:
                    rows = [(t2i_ids(g["prompts"][r]), uncond_ids(t2i_ids(g["prompts"][r])),
                             served[r]) for r in g["pick"]]
                    logits = ref_kl.cfg_logits(w, cfg, rows, cfg_w, 127)
                    gaps += [ref.served_gap(lg, served[r]) for r, lg in zip(g["pick"], logits)]
                    if control:
                        low = ref_kl.cfg_logits(w, cfg, rows, cfg_w, 7)
                        int4_gaps += [ref.served_gap(lg, lo.argmax(-1))
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
        greedy = any(g["greedy"] for g in self.groups)
        out = [{"name": "logit_gap", "value": max(gaps) if gaps else float("inf"),
                "limit": lim["logit_gap"]},
               {"name": "kda_state_rel", "value": state_rel if greedy else float("inf"),
                "limit": lim["kda_state_rel"]},
               {"name": "png_mean_abs", "value": max(pix), "limit": lim["png_mean_abs"]}]
        if control:
            out += [{"name": "control_int4_all_gap", "value": max(int4_gaps)},
                    {"name": "control_bf16_state_rel", "value": ctrl_bf16},
                    {"name": "control_scalar_decay_state_rel", "value": ctrl_scalar},
                    {"name": "control_png_mean_abs", "value": max(ctrl_pix)}]
        return out
