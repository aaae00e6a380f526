"""SimPO training of LoRA adapters on Janus-Pro, in plain PyTorch float32
(TF32 off): the reference for the step-5 cells.

One step, from the published recipe (SimPO over preference pairs; the
OSPO trainer):

- images → VQ-16 codebook ids (``reference.janus.vq_encode``) of the
  pixels scaled by 1/255 and normalized by the processor's mean and std;
- the sequence of each pair's two rows: the prompt's embeddings, right-
  padded to the text bucket and zeroed at the padding, then the generation
  aligner's embeddings of the image's ids; causal attention over all of it
  at positions ``arange``;
- the trunk with adapters on q, k, v, o, gate, up and down:
  ``y = x·Wᵀ + (α/r)·(drop(x)·A)·B``, dropout on the adapter's input only,
  each (step, layer, projection) mask drawn on the device from its own
  seeded generator as the configuration's trainer draws it;
- the generation head's log-softmax; the mean log-prob of each row's
  image ids (position t predicts id t + 1); loss
  ``mean(−log σ(β·(lp_chosen − lp_rejected − γ/β)))``;
- the gradient of every adapter; the global norm; clipping to 1; AdamW
  (fp32 moments, bias correction, eps outside the root, no weight decay).

The trunk runs one layer at a time: a no-grad pass keeps each layer's
input, and the backward recomputes one layer at a time under autograd.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from reference.janus import (Weights, attention, f32, gen_embeds, gen_head,
                             layer_weights, rms_norm, rope)

PROJ_INDEX = {"q_proj": 0, "k_proj": 1, "v_proj": 2, "o_proj": 3,
              "gate_proj": 4, "up_proj": 5, "down_proj": 6}


def fold_seed(seed: int, i: int) -> int:
    """The trainer's seed chain for dropout masks (step, then layer, then
    projection)."""
    return (seed * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) % (1 << 63)


def dropout_mask(shape, dtype, device, seed: int, rate: float) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    keep = torch.empty(shape, dtype=dtype, device=device).bernoulli_(1.0 - rate, generator=gen)
    return keep.float() / (1.0 - rate)


def _layer(x, lw, lora, li, hp, layer_seed, pos, heads, dh, eps, theta, dtype):
    b, t, _ = x.shape

    def proj(inp, wname, name):
        y = inp @ lw[wname].T
        a, bb = lora[name]["a"][li], lora[name]["b"][li]
        x_l = inp
        if hp["dropout"]:
            x_l = inp * dropout_mask(inp.shape, dtype, inp.device,
                                     fold_seed(layer_seed, PROJ_INDEX[name]),
                                     hp["dropout"])
        return y + hp["scaling"] * (x_l @ a) @ bb

    h = rms_norm(x, lw["attn_norm"], eps)
    q = rope(proj(h, "wq", "q_proj").view(b, t, heads, dh), pos, theta)
    k = rope(proj(h, "wk", "k_proj").view(b, t, heads, dh), pos, theta)
    v = proj(h, "wv", "v_proj").view(b, t, heads, dh)
    x = x + proj(attention(q, k, v), "wo", "o_proj")
    h = rms_norm(x, lw["mlp_norm"], eps)
    act = F.silu(proj(h, "w_gate", "gate_proj")) * proj(h, "w_up", "up_proj")
    return x + proj(act, "w_down", "down_proj")


def loss_and_grads(w: Weights, cfg: dict, text_ids: torch.Tensor,
                   text_mask: torch.Tensor, img_ids: torch.Tensor,
                   lora: Dict[str, Dict[str, torch.Tensor]], hp: dict,
                   step_seed: int, dtype=torch.bfloat16):
    """One micro-batch: ``text_ids``/``text_mask`` [B, Tt], ``img_ids``
    [2B, N] (chosen rows, then rejected) → (loss, {proj: {a, b}} grads)."""
    lc = cfg["language_config"]
    heads = lc["num_attention_heads"]
    dh = lc["hidden_size"] // heads
    eps, theta = lc.get("rms_norm_eps", 1e-6), lc.get("rope_theta", 10000.0)
    n_layers = lc["num_hidden_layers"]
    b, tt = text_ids.shape
    text = f32(w, "language_model.model.embed_tokens.weight")[text_ids] * text_mask[..., None]
    x = torch.cat([torch.cat([text, text]), gen_embeds(w, cfg, img_ids)], dim=1)
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None].expand(2 * b, t)
    leaves = [ab[k] for ab in lora.values() for k in ("a", "b")]
    for leaf in leaves:
        leaf.grad = None
    saved = []
    args = lambda li: (layer_weights(w, li, None), lora, li, hp,  # noqa: E731
                       fold_seed(step_seed, li), pos, heads, dh, eps, theta, dtype)
    with torch.no_grad():
        for li in range(n_layers):
            saved.append(x)
            x = _layer(x, *args(li))
    xf = x.detach().requires_grad_(True)
    hid = rms_norm(xf[:, tt - 1:t - 1], f32(w, "language_model.model.norm.weight"), eps)
    logp = torch.log_softmax(gen_head(w, hid), dim=-1)
    lp = logp.gather(-1, img_ids[..., None])[..., 0].mean(dim=-1)
    margin = lp[:b] - lp[b:] - hp["gamma_beta_ratio"]
    loss = (-F.logsigmoid(hp["beta"] * margin)).mean()
    loss.backward()
    g = xf.grad
    for li in reversed(range(n_layers)):
        xi = saved[li].requires_grad_(True)
        _layer(xi, *args(li)).backward(g)
        g = xi.grad
        saved[li] = None
    grads = {n: {k: ab[k].grad.clone() for k in ("a", "b")} for n, ab in lora.items()}
    return float(loss.detach()), grads


def train(w: Weights, cfg: dict, batches: Sequence[dict],
          init: Dict[str, Dict[str, torch.Tensor]], hp: dict, seed: int) -> dict:
    """``batches``: dicts of text_ids, text_mask, img_ids.  → losses, the
    first step's clipped gradient, the adapters after every step's update
    (``after``), the pre-clip gradient norms, and each step's gradients."""
    lora = {n: {k: t.detach().clone().float().requires_grad_(True)
                for k, t in ab.items()} for n, ab in init.items()}
    mu = {n: {k: torch.zeros_like(t) for k, t in ab.items()} for n, ab in lora.items()}
    nu = {n: {k: torch.zeros_like(t) for k, t in ab.items()} for n, ab in lora.items()}
    b1, b2 = hp["betas"]
    out: Dict[str, List] = {"loss": [], "grad_norm": [], "grads": []}
    for i, batch in enumerate(batches):
        loss, grads = loss_and_grads(w, cfg, batch["text_ids"], batch["text_mask"],
                                     batch["img_ids"], lora, hp, fold_seed(seed, i))
        norm = torch.sqrt(sum((g * g).sum() for ab in grads.values() for g in ab.values()))
        scale = 1.0 if norm < hp["clip"] else hp["clip"] / norm
        clipped = {n: {k: g * scale for k, g in ab.items()} for n, ab in grads.items()}
        out["loss"].append(loss)
        out["grad_norm"].append(float(norm))
        out["grads"].append(grads)
        if i == 0:
            out["grad1"] = clipped
        c1, c2 = 1 - b1 ** (i + 1), 1 - b2 ** (i + 1)
        with torch.no_grad():
            for n, ab in lora.items():
                for k, p in ab.items():
                    g = clipped[n][k]
                    mu[n][k].mul_(b1).add_((1 - b1) * g)
                    nu[n][k].mul_(b2).add_((1 - b2) * g * g)
                    p.sub_(hp["lr"] * (mu[n][k] / c1)
                           / (torch.sqrt(nu[n][k] / c2) + hp["eps"]))
    out["after"] = {n: {k: t.detach() for k, t in ab.items()} for n, ab in lora.items()}
    return out


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              skip=()) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger; leaves in ``skip`` left out."""
    ref_norms = {p: float(t.float().norm()) for p, t in reference.items()}
    med = sorted(ref_norms.values())[len(ref_norms) // 2]
    worst = 0.0
    for p, r in ref_norms.items():
        if p in skip:
            continue
        gap = abs(float(program[p].float().norm()) - r)
        worst = max(worst, gap / max(r, med, 1e-30))
    return worst


def leaf_diffs(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
               skip=()) -> float:
    """The worst leaf's norm of the difference between the program and the
    reference, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; leaves in ``skip`` left out."""
    ref_norms = {p: float(t.float().norm()) for p, t in reference.items()}
    med = sorted(ref_norms.values())[len(ref_norms) // 2]
    return max((float((program[p].float() - reference[p].float()).norm())
                / max(r, med, 1e-30) for p, r in ref_norms.items() if p not in skip),
               default=0.0)


def flat(tree: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {f"{n}/{k}": t for n, ab in tree.items() for k, t in ab.items()}
