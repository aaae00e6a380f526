"""Janus-Pro's understanding path in plain PyTorch, float32 (TF32 off): the
reference for the step-4b cells.

- The yes/no question conversation, as the published processor renders it
  with its default system prompt: ``{system}\\n\\n<|User|>: <image>\\n{q}
  Please answer 'yes' or 'no' without explanation.\\n\\n<|Assistant|>:``,
  the image placeholder expanded to ``<begin_of_image>``, one placeholder a
  patch, ``<end_of_image>``; ids by the byte-level stand-in of
  ``reference.tokens``.
- SigLIP-L/16 over the normalized pixels: patch convolution, learned
  position embedding, pre-norm blocks (LayerNorm eps 1e-6, biased qkv,
  bidirectional attention, exact-GELU MLP), final LayerNorm; the aligner
  Linear → GELU → Linear; its rows replace the placeholders' embeddings.
- The trunk over the conversation, int8 weights worked out from the bf16
  ones; the readout at the last position: the softmax over the vocabulary
  of the text head, and the probabilities of the answers' last tokens.

The cached scoring path is followed in its arithmetic: keys and values of
the text before the image stay exact (a model-dtype cache), those from the
image on are read through an int8 cache by the question's own tokens (the
image prefill itself attends exact values).  The boundary is the end of
the image's line, the longest token prefix that every question of a batch
shares when the questions differ in their first token.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference.janus import (Weights, attention, f32, layer_weights, mlp_gelu,
                             model_dtype, quantize_kv, rms_norm, rope)
from reference.tokens import BOS, IMAGE, IMAGE_END, IMAGE_START

SYSTEM = ("You are a helpful language and vision assistant. You are able to "
          "understand the visual content that the user provides, and assist "
          "the user with a variety of tasks using natural language.")
ASK = " Please answer 'yes' or 'no' without explanation."


def conversation_ids(question: str, n_image_tokens: int) -> Tuple[List[int], int, int]:
    """→ (ids, index of the first image token, length of the prefix every
    question shares: through the newline after ``<end_of_image>``)."""
    head = [BOS, *f"{SYSTEM}\n\n<|User|>: ".encode()]
    span = [IMAGE_START] + [IMAGE] * n_image_tokens + [IMAGE_END]
    tail = list(f"\n{question.strip()}{ASK}\n\n<|Assistant|>:".encode())
    ids = head + span + tail
    return ids, len(head) + 1, len(head) + len(span) + 1


def answer_ids() -> Tuple[int, int]:
    """The last tokens of "yes"/"Yes" and "no"/"No" (one byte each here)."""
    return ord("s"), ord("o")


def layer_norm(x, w, b, eps=1e-6):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def siglip(w: Weights, cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """Normalized pixels [n, H, W, 3] → aligned image embeddings [n, N, D]."""
    vp = cfg["vision_config"]["params"]
    pre = "vision_model.vision_tower."
    heads = vp["heads"]
    layers = vp["layers"]
    sel = vp.get("select_layer", -1)
    depth = min(layers, layers + sel + 1) if sel <= 0 else min(layers, sel)
    x = F.conv2d(pixels.permute(0, 3, 1, 2), f32(w, pre + "patch_embed.proj.weight"),
                 f32(w, pre + "patch_embed.proj.bias"), stride=vp["patch_size"])
    x = x.flatten(2).transpose(1, 2) + f32(w, pre + "pos_embed")
    n, t, d = x.shape
    for i in range(depth):
        b = f"{pre}blocks.{i}."
        h = layer_norm(x, f32(w, b + "norm1.weight"), f32(w, b + "norm1.bias"))
        qkv = (h @ f32(w, b + "attn.qkv.weight").T + f32(w, b + "attn.qkv.bias")
               ).view(n, t, 3, heads, d // heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d // heads) ** -0.5
        a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(n, t, d)
        x = x + a @ f32(w, b + "attn.proj.weight").T + f32(w, b + "attn.proj.bias")
        h = layer_norm(x, f32(w, b + "norm2.weight"), f32(w, b + "norm2.bias"))
        h = F.gelu(h @ f32(w, b + "mlp.fc1.weight").T + f32(w, b + "mlp.fc1.bias"))
        x = x + h @ f32(w, b + "mlp.fc2.weight").T + f32(w, b + "mlp.fc2.bias")
    x = layer_norm(x, f32(w, pre + "norm.weight"), f32(w, pre + "norm.bias"))
    return mlp_gelu(w, "aligner.", cfg["aligner_config"]["params"]["depth"], x)


def readouts(w: Weights, cfg: dict, image_embeds: torch.Tensor,
             questions: Sequence[str], weight_levels: int, kv_levels: int) -> torch.Tensor:
    """One image's answers: → log-probabilities [Q, 2] of (yes, no) at the
    last position of each question's conversation."""
    lc = cfg["language_config"]
    heads = lc["num_attention_heads"]
    dh = lc["hidden_size"] // heads
    eps, theta = lc.get("rms_norm_eps", 1e-6), lc.get("rope_theta", 10000.0)
    dev = image_embeds.device
    n_img = image_embeds.shape[0]
    convs = [conversation_ids(q, n_img) for q in questions]
    ids0, img_at, common = convs[0]
    table = f32(w, "language_model.model.embed_tokens.weight")
    x_p = table[torch.tensor(ids0[:common], device=dev)].clone()
    x_p[img_at:img_at + n_img] = image_embeds
    x_p = x_p[None]
    xs = [table[torch.tensor(ids[common:], device=dev)][None] for ids, _, _ in convs]
    pos_p = torch.arange(common, device=dev)[None]
    for li in range(lc["num_hidden_layers"]):
        lw = layer_weights(w, li, weight_levels, model_dtype(cfg))

        def qkv(h, pos):
            b, n, _ = h.shape
            return (rope((h @ lw["wq"].T).view(b, n, heads, dh), pos, theta),
                    rope((h @ lw["wk"].T).view(b, n, heads, dh), pos, theta),
                    (h @ lw["wv"].T).view(b, n, heads, dh))

        def mlp(x):
            h = rms_norm(x, lw["mlp_norm"], eps)
            return x + (F.silu(h @ lw["w_gate"].T) * (h @ lw["w_up"].T)) @ lw["w_down"].T

        q, k, v = qkv(rms_norm(x_p, lw["attn_norm"], eps), pos_p)
        k_read = torch.cat([k[:, :img_at], quantize_kv(k[:, img_at:], kv_levels)], 1)
        v_read = torch.cat([v[:, :img_at], quantize_kv(v[:, img_at:], kv_levels)], 1)
        x_p_next = mlp(x_p + attention(q, k, v) @ lw["wo"].T)
        for i, x in enumerate(xs):
            pos = torch.arange(common, common + x.shape[1], device=dev)[None]
            qs, ks, vs = qkv(rms_norm(x, lw["attn_norm"], eps), pos)
            a = attention(qs, torch.cat([k_read, quantize_kv(ks, kv_levels)], 1),
                          torch.cat([v_read, quantize_kv(vs, kv_levels)], 1), q_offset=common)
            xs[i] = mlp(x + a @ lw["wo"].T)
        x_p = x_p_next
    yes, no = answer_ids()
    head = f32(w, "language_model.lm_head.weight")
    out = []
    for x in xs:
        hid = rms_norm(x[:, -1], f32(w, "language_model.model.norm.weight"), eps)
        logp = torch.log_softmax(hid @ head.T, dim=-1)[0]
        out.append(torch.stack([logp[yes], logp[no]]))
    return torch.stack(out)


def preference_pair(base: List[dict], negative: List[dict]):
    """OSPO's pair selection over an item's three base and three negative
    images' scores (``local_score``, ``global_score``): keep index pairs
    whose local and global gaps are both non-negative, normalize each gap
    by the largest, and choose the largest ratio local / (global + 1e-8).
    → the chosen index, or None."""
    pairs = []
    for i, (b, n) in enumerate(zip(base, negative)):
        if b is None or n is None:
            continue
        lg, gg = b["local_score"] - n["local_score"], b["global_score"] - n["global_score"]
        if lg >= 0 and gg >= 0:
            pairs.append((i, lg, gg))
    if not pairs:
        return None
    ml = max(abs(p[1]) for p in pairs)
    mg = max(abs(p[2]) for p in pairs)
    best, best_i = -float("inf"), None
    for i, lg, gg in pairs:
        s = (abs(lg) / (ml + 1e-8)) / (abs(gg) / (mg + 1e-8) + 1e-8)
        if s > best:
            best, best_i = s, i
    return best_i


def scores(answers: Sequence[Tuple[float, float]]) -> dict:
    """(p_yes, p_no) a question, the last the global one → local and global
    scores."""
    diffs = [y - n for y, n in answers]
    return {"local_score": sum(diffs[:-1]) / max(len(diffs) - 1, 1),
            "global_score": diffs[-1]}
