"""Self-VQA scoring engine (step 4b, the understanding path) — counterpart of
``ospo_tpu/engine/scoring.py``.

Each (image, question) conversation ends in the model's yes/no readout, as
``JanusProScoreWrapper`` (``ospo/wrapper/vqa.py:161-225``): the softmax at
the final position, p_yes = max over the {"yes", "Yes"} last-token ids, p_no
likewise; per image, the local score is the mean gap over all but the last
question, the global score the last question's gap.

The default path shares work on the tokenized sequences, so its math is the
unshared forward's token for token:

- the pre-image segment (chat header and system prompt, identical for every
  image and question and pure text) prefills once at B = 1 into a bf16
  cache through the flash kernel and joins every later attention as a
  batch-shared ``prefix_kv``;
- the per-image remainder (the image span and the text up to where the
  questions differ) prefills into an ``shbd`` cache (bf16 or int8) with the
  ViT's aligned embeddings spliced in; without the pre-image split it is one
  flash prefill from position 0 (the single-segment program);
- each question's suffix runs as a cached multi-token step against that
  cache (``llama.forward`` with T > 1), the cache length reset between
  questions so each suffix overwrites the same rows; on a w8a8 trunk
  ``readout_w8a16`` runs them weight-only.

Chunks are cut into balanced slices under a row-token budget (images × cache
rows); a CUDA out-of-memory error halves the slice (sticky) and, at one
image, falls back for good to the unshared N·Q-row forward.  Under tensor
parallel the ranks of a model group agree on each retry (an all-reduced
flag), so they run the same programs.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import traceback
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import llama
from ospo_tpu_torch.ops import quant
from ospo_tpu_torch.ops.pixels import normalize_pixels
from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.processing import Processor
from ospo_tpu_torch.utils.profiling import span

# per-image cache rows × images one shared-program slice may hold: the JAX
# package's calibration for its int8 prefix cache, halved for bf16
ROW_TOKEN_BUDGET = {"int8": 12288, False: 6144}


def _bucket(n: int, step: int = 64) -> int:
    return max(step, ((n + step - 1) // step) * step)


class SharedPrep(NamedTuple):
    """Host-prepared operands of one shared-prefix call
    (:meth:`ScoringEngine.prepare_shared_multi`): ``operands`` = prefix ids,
    prefix mask, uint8 pixels, image-slot mask, embedding mask (each with N
    rows), suffix ids and mask ``[Q, N, T_b]``; ``pre`` = the B = 1
    pre-image ids and mask, or None (single-segment program);
    ``row_tokens`` = the per-image cache length (prefix bucket + suffix
    bucket)."""
    operands: List[np.ndarray]
    q_counts: List[int]
    n_real: int
    pre: Optional[List[np.ndarray]] = None
    row_tokens: int = 0


def parse_kv_quant(kv_quant):
    """False (model-dtype cache) or "int8"; anything else is an error."""
    if kv_quant in (None, False, "", "none", "off"):
        return False
    if kv_quant in (True, "int8"):
        return "int8"
    if kv_quant == "int4":
        raise ValueError("scoring supports bf16 or int8 prefix caches (int4 "
                         "KV is a decode-engine option)")
    raise ValueError(f"score_kv_quant {kv_quant!r}: scoring takes a bf16 or "
                     "an int8 prefix cache")


class ScoringEngine:
    def __init__(self, model: janus_lib.JanusModel, processor: Processor,
                 kv_quant=False, pre_image_prefix: bool = True):
        janus_lib.refuse_own_trunk(model, "step 4b (the scoring engine)")
        self.model = model
        self.processor = processor
        self.device = model.device
        self.kv_quant = parse_kv_quant(kv_quant)
        self.pre_image_prefix = bool(pre_image_prefix)
        # precision-mixed readout (``ospo_tpu/engine/scoring.py:88-124``):
        # on a w8a8 trunk the question suffixes, whose last position feeds
        # the yes/no readout, run weight-only (W8A16) while the prefills
        # keep the int8 x int8 product; no-op for other trunks.  The JAX
        # package reads it from OSPO_SCORE_READOUT; here callers set it
        self.readout_w8a16 = False
        self.row_token_budget = ROW_TOKEN_BUDGET[self.kv_quant]
        self._shared_oom = False  # sticky fallback (score_images_multi)
        # what the run took besides the shared path: halved slices after an
        # OOM, calls of the unshared forward, per-image retries (step4)
        self.counts = {"oom_retries": 0, "unshared_calls": 0,
                       "per_image_retries": 0}
        tok = processor.tokenizer
        last = lambda word: tok.encode(word, add_bos=False)[-1]  # noqa: E731
        self.yes_ids = [last("yes"), last("Yes")]
        self.no_ids = [last("no"), last("No")]

    # ------------------------------------------------------------------
    # device pieces
    # ------------------------------------------------------------------
    def _yes_no(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, V] last-position logits → [B, 2] (p_yes, p_no) on the device."""
        probs = torch.softmax(logits.float(), dim=-1)
        sel = probs[:, torch.as_tensor(self.yes_ids + self.no_ids,
                                       device=probs.device)]
        n_yes = len(self.yes_ids)
        return torch.stack([sel[:, :n_yes].amax(dim=-1),
                            sel[:, n_yes:].amax(dim=-1)], dim=-1)

    def _encode_images(self, pixels: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] uint8 (normalised here) or host-normalised float →
        aligned image embeddings [N, T2, D]."""
        pixels = normalize_pixels(pixels, self.processor.image_processor)
        return janus_lib.encode_images(self.model.params, self.model.cfg, pixels)

    def _prefill_pre(self, pre_ids: torch.Tensor, pre_mask: torch.Tensor):
        """The B = 1 pre-image prefill into a bf16 cache → prefix_kv."""
        params, cfg = self.model.params, self.model.cfg
        pkv = janus_lib.init_kv_cache(params, cfg, 1, pre_ids.shape[1],
                                      device=self.device)
        _, pkv = janus_lib.language_forward(
            params, cfg, janus_lib.embed_text(params, pre_ids), pre_mask,
            llama.positions_from_mask(pre_mask), kv_cache=pkv, self_attn=True)
        return {"k": pkv["k"][:, :, :, 0], "v": pkv["v"][:, :, :, 0],
                "mask": pre_mask}

    def _prefill_images(self, ids, mask, img_embeds, seq_mask, emb_mask,
                        t_b: int, prefix, pre_len: int):
        """The per-image prefill into an ``shbd`` cache of prefix + suffix
        rows; positions continue after the pre-image segment."""
        params, cfg = self.model.params, self.model.cfg
        b, p = ids.shape
        embeds = janus_lib.prepare_inputs_embeds(
            params, cfg, ids, None, seq_mask, emb_mask, img_embeds=img_embeds)
        kv = janus_lib.init_kv_cache(params, cfg, b, p + t_b,
                                     quantized=self.kv_quant,
                                     device=self.device)
        _, kv = janus_lib.language_forward(
            params, cfg, embeds, mask, pre_len + llama.positions_from_mask(mask),
            kv_cache=kv, self_attn=True, prefix_kv=prefix)
        return kv

    def _suffix_probs(self, kv, mask, prefix_len, sfx_ids, sfx_mask, prefix):
        """Every question's suffix [Q, N, T_b] as a cached multi-token step
        against the per-image cache → [Q, N, 2]."""
        params, cfg = self.model.params, self.model.cfg
        p = mask.shape[1]
        out = []
        for i in range(sfx_ids.shape[0]):
            kv["length"] = p  # this question overwrites the last one's rows
            pos = prefix_len - 1 + torch.cumsum(sfx_mask[i], dim=-1).clamp_min(1)
            window = torch.cat([mask, sfx_mask[i]], dim=-1)
            with (quant.w8a16_override() if self.readout_w8a16
                  else contextlib.nullcontext()):
                hidden, _ = janus_lib.language_forward(
                    params, cfg,
                    janus_lib.embed_text(params, sfx_ids[i].clamp_min(0)),
                    window, pos, kv_cache=kv, prefix_kv=prefix)
            out.append(self._yes_no(
                janus_lib.lm_logits(params, hidden[:, -1:])[:, 0]))
        return torch.stack(out)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def question_conversations(self, image, questions: Sequence[str]):
        """Per-question single-image yes/no conversations
        (``build_conversation``, ospo/wrapper/vqa.py:149-158)."""
        return [[
            {"role": "<|User|>",
             "content": f"<image_placeholder>\n{q} Please answer 'yes' or 'no' without explanation.",
             "images": [image]},
            {"role": "<|Assistant|>", "content": ""},
        ] for q in questions]

    def score_image(self, image, questions: Sequence[str]) -> Dict:
        return self.score_images([image], questions)[0]

    def score_images(self, images: Sequence, questions: Sequence[str],
                     share_prefix: bool = True) -> List[Dict]:
        return self.score_images_multi(images, [list(questions)] * len(images),
                                       share_prefix=share_prefix)

    def score_images_multi(self, images: Sequence,
                           questions_per_image: Sequence[Sequence[str]],
                           share_prefix: bool = True,
                           prep: Optional[SharedPrep] = None) -> List[Dict]:
        """N uint8 [H, W, 3] images, each with its own question list
        (``ospo_tpu/engine/scoring.py:314-419``).  ``prep`` is a
        host-prepared operand package (:meth:`prepare_shared_multi`)."""
        if len(images) != len(questions_per_image):
            raise ValueError("one question list per image")
        if not len(images):
            return []
        if (share_prefix and not self._shared_oom
                and all(qs for qs in questions_per_image)):
            if prep is None:
                prep = self.prepare_shared_multi(images, questions_per_image)
            while True:
                oom = False
                try:
                    out = self._execute_shared_multi(prep)
                except torch.cuda.OutOfMemoryError:
                    traceback.print_exc(file=sys.stderr)
                    oom = True
                if not mesh_lib.any_model(oom):
                    return out
                # retry outside the handler, whose traceback pins the failed
                # slice's tensors
                gc.collect()
                torch.cuda.empty_cache()
                n_failed = min(prep.operands[0].shape[0],
                               self._fit_images(prep.row_tokens))
                if n_failed > 1:
                    n_half = n_failed // 2
                    self.row_token_budget = min(self.row_token_budget,
                                                n_half * prep.row_tokens)
                    self.counts["oom_retries"] += 1
                    print(f"# scoring: shared-prefix slice of {n_failed} "
                          f"images ran out of memory — retrying at {n_half} "
                          f"images (row-token budget {self.row_token_budget}, "
                          "sticky)", file=sys.stderr)
                    continue
                print("# scoring: shared-prefix path out of memory at one "
                      "image — falling back to the single-forward path",
                      file=sys.stderr)
                self._shared_oom = True
                break
        # unshared fallback: whole images packed into ≤ 32-row forwards
        out: List[Dict] = []
        group: List = []
        gqs: List[List[str]] = []
        rows = 0
        for img, qs in zip(images, questions_per_image):
            if rows and rows + len(qs) > 32:
                out.extend(self._score_images_full(group, gqs))
                group, gqs, rows = [], [], 0
            group.append(img)
            gqs.append(list(qs))
            rows += len(qs)
        if group:
            out.extend(self._score_images_full(group, gqs))
        return out

    def prepare_shared_multi(self, images: Sequence,
                             questions_per_image) -> SharedPrep:
        """Host half of the shared path (``scoring.py:426-538``): tokenize
        each image's conversations (the ids do not depend on the image, so
        no image is processed for them), split off the common token prefix
        and the pre-image segment, pad to buckets (pre-image 16, prefix 64,
        suffix 16; Q padded by repeating the last suffix), and resize the
        images to uint8 pixels."""
        if not len(images) or any(not qs for qs in questions_per_image):
            raise ValueError(
                "shared-prefix scoring needs ≥1 image and ≥1 question per "
                "image; use the unshared path for empty items")
        proc = self.processor
        n = len(images)
        ids_per_img = [[proc.process_one(conversations=c).input_ids
                        for c in self.question_conversations(None, qs)]
                       for qs in questions_per_image]
        all_ids = [a for ids in ids_per_img for a in ids]
        minlen = min(len(a) for a in all_ids)
        stacked = np.stack([a[:minlen] for a in all_ids])
        neq = (stacked != stacked[0]).any(axis=0)
        common = minlen if not neq.any() else int(np.argmax(neq))
        common = min(common, minlen - 1)  # ≥ 1 suffix token
        seq_mask_full = all_ids[0] == proc.image_id
        if seq_mask_full[common:].any():
            raise ValueError("the image span must sit inside the shared prefix")

        pre, pre_n = None, 0
        if self.pre_image_prefix and seq_mask_full[:common].any():
            img_start = int(np.argmax(seq_mask_full[:common]))
            if img_start >= 8:  # a shorter segment is not worth a phase
                pre_n = img_start
                c_pre = _bucket(pre_n, step=16)
                pre_ids = np.full((1, c_pre), proc.pad_id, np.int32)
                pre_mask = np.zeros((1, c_pre), np.int32)
                pre_ids[0, c_pre - pre_n:] = all_ids[0][:pre_n]
                pre_mask[0, c_pre - pre_n:] = 1
                pre = [pre_ids, pre_mask]

        rest = common - pre_n
        p_b = _bucket(rest)
        lpad = p_b - rest
        prefix_ids = np.pad(all_ids[0][pre_n:common], (lpad, 0),
                            constant_values=proc.pad_id)
        prefix_mask = np.pad(np.ones(rest, np.int32), (lpad, 0))
        prefix_seq_mask = np.pad(seq_mask_full[pre_n:common], (lpad, 0))
        pixel_values = np.stack([proc.image_processor.process_one_u8(img)
                                 for img in images])
        emb_mask = np.ones((n, 1, proc.num_image_tokens), bool)

        q_counts = [len(ids) for ids in ids_per_img]
        q_b = max(q_counts)
        t_b = _bucket(max(len(a) - common for a in all_ids), step=16)
        sfx_ids = np.full((q_b, n, t_b), proc.pad_id, np.int32)
        sfx_mask = np.zeros((q_b, n, t_b), np.int32)
        for i, ids in enumerate(ids_per_img):
            for qi in range(q_b):
                s = ids[min(qi, len(ids) - 1)][common:]
                sfx_ids[qi, i, t_b - len(s):] = s
                sfx_mask[qi, i, t_b - len(s):] = 1
        operands = [np.tile(prefix_ids, (n, 1)), np.tile(prefix_mask, (n, 1)),
                    pixel_values, np.tile(prefix_seq_mask, (n, 1)), emb_mask,
                    sfx_ids, sfx_mask]
        return SharedPrep(operands, q_counts, n, pre, row_tokens=p_b + t_b)

    def _fit_images(self, row_tokens: int) -> int:
        """Images per shared-program call under the row-token budget (≥ 1)."""
        if row_tokens <= 0:
            return 10 ** 9
        return max(1, self.row_token_budget // row_tokens)

    def _execute_shared_multi(self, prep: SharedPrep) -> List[Dict]:
        """Device half: balanced slices under the row-token budget (16 over
        a fit of 13 → 2 × 8), the ragged last one padded by repeating its
        last image; trimmed to the real images."""
        ops, q_counts = prep.operands, prep.q_counts
        n = ops[0].shape[0]
        n_fit = self._fit_images(prep.row_tokens)
        if n <= n_fit:
            return self._execute_shared_slice(ops, prep.pre, q_counts)[:prep.n_real]
        n_slices = -(-n // n_fit)
        per = -(-n // n_slices)
        out: List[Dict] = []
        for s0 in range(0, n, per):
            sl = ([o[s0:s0 + per] for o in ops[:5]]
                  + [o[:, s0:s0 + per] for o in ops[5:]])
            qc = list(q_counts[s0:s0 + per])
            k = sl[0].shape[0]
            if k < per:
                reps = per - k
                sl = ([np.concatenate([o, np.repeat(o[-1:], reps, 0)])
                       for o in sl[:5]]
                      + [np.concatenate([o, np.repeat(o[:, -1:], reps, 1)], axis=1)
                         for o in sl[5:]])
                qc += [qc[-1]] * reps
            out.extend(self._execute_shared_slice(sl, prep.pre, qc)[:k])
        return out[:prep.n_real]

    @torch.inference_mode()
    def _execute_shared_slice(self, operands, pre, q_counts: List[int]
                              ) -> List[Dict]:
        """One slice: the ViT, the pre-image and per-image prefills and the
        suffixes (``scoring.py:164-283``); scores for every row.  Spans:
        ``scoring.upload``, ``.vit``, ``.prefill``, ``.suffix`` (question
        rows run, Q_b·N, and used, the rows' own question counts) and
        ``.readback``."""
        dev = self.device
        with span("scoring.upload"):
            ids, mask, pixels, seq_mask, emb_mask, sfx_ids, sfx_mask = (
                torch.as_tensor(np.ascontiguousarray(x)).to(dev) for x in operands)
            ids, sfx_ids = ids.long(), sfx_ids.long()
        with span("scoring.vit"):
            img_embeds = self._encode_images(pixels)
        with span("scoring.prefill"):
            prefix, pre_len = None, 0
            if pre is not None:
                pre_len = int(pre[1].sum())
                prefix = self._prefill_pre(torch.as_tensor(pre[0]).to(dev).long(),
                                           torch.as_tensor(pre[1]).to(dev))
            kv = self._prefill_images(ids, mask, img_embeds, seq_mask, emb_mask,
                                      sfx_ids.shape[-1], prefix, pre_len)
            prefix_len = pre_len + mask.sum(dim=-1, keepdim=True)
        with span("scoring.suffix", rows_run=sfx_ids.shape[0] * sfx_ids.shape[1],
                  rows_used=sum(q_counts)):
            yn = self._suffix_probs(kv, mask, prefix_len, sfx_ids, sfx_mask, prefix)
        with span("scoring.readback"):
            yn = yn.cpu().numpy()                                  # [Q_b, N, 2]
        return [self._collect_scores(np.ascontiguousarray(yn[:q, i]), 1, q)[0]
                for i, q in enumerate(q_counts)]

    @torch.inference_mode()
    def _score_images_full(self, images: Sequence,
                           questions_per_image) -> List[Dict]:
        """The unshared forward (``scoring.py:627-660``): one row per
        (image, question), image-major, left-padded to a 64 bucket, through
        the no-cache trunk."""
        self.counts["unshared_calls"] += 1
        proc = self.processor
        params, cfg = self.model.params, self.model.cfg
        prepares = [proc.process_one(conversations=c, images=[img])
                    for img, qs in zip(images, questions_per_image)
                    for c in self.question_conversations(img, qs)]
        batch = proc.batchify(prepares)
        t = batch.input_ids.shape[1]
        pad = ((0, 0), (_bucket(t) - t, 0))
        dev = self.device
        ids = torch.as_tensor(np.pad(batch.input_ids, pad,
                                     constant_values=proc.pad_id)).to(dev).long()
        attn = torch.as_tensor(np.pad(batch.attention_mask, pad)).to(dev)
        seq_mask = torch.as_tensor(np.pad(batch.images_seq_mask, pad)).to(dev)
        emb_mask = torch.as_tensor(batch.images_emb_mask).to(dev)
        pixels = torch.as_tensor(batch.pixel_values).to(dev)
        img_embeds = self._encode_images(pixels.reshape(-1, *pixels.shape[2:]))
        embeds = janus_lib.prepare_inputs_embeds(
            params, cfg, ids, None, seq_mask, emb_mask, img_embeds=img_embeds)
        hidden, _ = janus_lib.language_forward(
            params, cfg, embeds, attn, llama.positions_from_mask(attn))
        yn = self._yes_no(janus_lib.lm_logits(params, hidden[:, -1:])[:, 0]
                          ).cpu().numpy()
        results: List[Dict] = []
        off = 0
        for qs in questions_per_image:
            results.extend(self._collect_scores(yn[off:off + len(qs)], 1, len(qs)))
            off += len(qs)
        return results

    def _collect_scores(self, yn: np.ndarray, n_images: int,
                        q_count: int) -> List[Dict]:
        """[N·Q, 2] (p_yes, p_no) rows, image-major → per-image local and
        global scores (vqa.py:161-225)."""
        results: List[Dict] = []
        for img_idx in range(n_images):
            score_sum = 0.0
            global_score = 0.0
            answer_metadata: List[dict] = []
            for q_idx in range(q_count):
                row = img_idx * q_count + q_idx
                p_yes = float(yn[row, 0])
                p_no = float(yn[row, 1])
                answer_metadata.append({
                    "p_yes": p_yes,
                    "p_no": p_no,
                    "answer": ("yes" if p_yes > p_no
                               else ("no" if p_no > p_yes else "tie")),
                })
                if q_idx == q_count - 1:
                    global_score = p_yes - p_no
                else:
                    score_sum += p_yes - p_no
            results.append({
                "local_score": float(score_sum / max(q_count - 1, 1)),
                "global_score": float(global_score),
                "answer_metadata": answer_metadata,
            })
        return results


def compute_preference_strength(base_img_dict: Dict, negative_img_dict: Dict):
    """Pair selection — a verbatim port of the algorithm core
    (``ospo/wrapper/vqa.py:228-280``): keep (base_i, negative_i) pairs with
    non-negative local & global gaps, normalise by max |gap|, strength =
    norm_local / (norm_global + 1e-8), pick argmax."""
    bases = [base_img_dict.get(f"base_{i}") for i in range(3)]
    negatives = [negative_img_dict.get(f"negative_{i}") for i in range(3)]
    if not any(b is not None for b in bases) or not any(
        n is not None for n in negatives
    ):
        return None

    pairs = []
    for idx in range(3):
        base, neg = bases[idx], negatives[idx]
        if base is None or neg is None:
            continue
        local_gap = base["local_score"] - neg["local_score"]
        global_gap = base["global_score"] - neg["global_score"]
        if local_gap >= 0 and global_gap >= 0:
            pairs.append({"pair_idx": idx, "local_gap": local_gap,
                          "global_gap": global_gap})
    if not pairs:
        return None

    max_local = max(abs(p["local_gap"]) for p in pairs)
    max_global = max(abs(p["global_gap"]) for p in pairs)
    best_score, best_pair = -np.inf, None
    for pair in pairs:
        norm_local = abs(pair["local_gap"]) / (max_local + 1e-8)
        norm_global = abs(pair["global_gap"]) / (max_global + 1e-8)
        strength = norm_local / (norm_global + 1e-8)
        if strength > best_score:
            best_score, best_pair = strength, pair
    if best_pair is None:
        return None

    chosen = base_img_dict[f"base_{best_pair['pair_idx']}"]["path"]
    rejected = negative_img_dict[f"negative_{best_pair['pair_idx']}"]["path"]
    return chosen, rejected, {
        "local_gap": best_pair["local_gap"],
        "global_gap": best_pair["global_gap"],
        "preference_strength": best_score,
    }
