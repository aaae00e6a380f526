"""Batched text generation (steps 1, 2 and 4a) — counterpart of
``ospo_tpu/engine/text_engine.py``.

- Prompts are left-padded into buckets (``_bucket_tail``: 64-token steps up
  to 512, 256 beyond; batches to a power of two capped at ``batch_cap``,
  pad rows repeating the last row), as in the reference, so both packages
  run the same shapes.
- The plain program prefills the batch into a batch-minor KV cache of
  ``t_prompt + max_new`` rows (flash kernel), then decodes one token a step
  (decode-attention kernel; an int4 cache, ``kv_quant: int4``, through the
  plain ``xla_attention``).
- The shared-prefix program, for batches whose prompts share at least
  ``SHARED_PREFIX_MIN`` leading tokens (a few-shot template), prefills that
  prefix once at B = 1 into a bf16 cache and reads it as a batch-shared
  attention segment; the per-row cache holds only the tails and the new
  rows (``llama.forward(prefix_kv=)``; exact math: one softmax over prefix
  and own keys).
- Each step samples from fp32 ``lm_head`` logits (``ops/sampling.sample_token``:
  greedy, temperature, top-p); a finished row writes eos; the loop ends
  early once every row has finished, checked every ``EOS_CHECK_EVERY`` steps
  so that the host does not wait for the device each step.

Returns only the new ids (eos-filled ``[B, max_new_tokens]``).  Not ported:
the TPU compile-crash batch split, ``prewarm`` and ``DispatchStats``
(ahead-of-time XLA compilation has no counterpart here).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import llama
from ospo_tpu_torch.ops.quant import parse_kv_quant
from ospo_tpu_torch.ops.sampling import sample_token
from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.processing import Processor


def _bucket(n: int, step: int = 64) -> int:
    return max(step, ((n + step - 1) // step) * step)


def _bucket_tail(n: int) -> int:
    """Per-row sequence bucket (tails and plain prompts): 64-token steps up
    to 512, 256-token steps beyond (``ospo_tpu/engine/text_engine.py:43``)."""
    return _bucket(n) if n <= 512 else _bucket(n, step=256)


class TextGenEngine:
    # a common prefix shorter than this runs the plain program: below it the
    # extra B=1 prefill costs more than sharing saves
    SHARED_PREFIX_MIN = 64
    # decode steps between host reads of "every row finished"; finished rows
    # only write eos, so the interval changes no output
    EOS_CHECK_EVERY = 16

    def __init__(
        self,
        model: janus_lib.JanusModel,
        processor: Processor,
        max_new_tokens: int = 256,
        temperature: float = 1.0,
        top_p: Optional[float] = None,
        do_sample: bool = True,
        kv_quant=False,
        batch_cap: Optional[int] = None,
        shared_prefix: Optional[bool] = None,
    ):
        janus_lib.refuse_own_trunk(model, "the text engine (steps 1, 2 and 4a)")
        self.model = model
        self.device = model.device
        self.processor = processor
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_p = top_p
        self.do_sample = bool(do_sample)
        # an int4 per-row cache (shbd, two heads a byte) is read by the
        # plain forms: the decode kernel takes model-dtype and int8 caches
        self.kv_quant = parse_kv_quant(kv_quant)
        self.batch_cap = batch_cap
        self.shared_prefix = True if shared_prefix is None else bool(shared_prefix)
        # step_hook(step) is called on the host before each step's sampling
        # (step 0 right after the prefill); chip_smoke.py and
        # scripts/profile_torch_text.py time the decode loop through it
        self.step_hook = None

    @classmethod
    def from_generation_config(cls, model, processor, gen_cfg, kv_quant=False,
                               batch_cap=None,
                               shared_prefix=None) -> "TextGenEngine":
        """Build from a step config's ``generation_config`` block (the HF
        generate kwargs of the reference)."""
        gen_cfg = gen_cfg or {}
        return cls(model, processor,
                   max_new_tokens=gen_cfg.get("max_new_tokens", 256),
                   temperature=gen_cfg.get("temperature", 1.0),
                   top_p=gen_cfg.get("top_p"),
                   do_sample=gen_cfg.get("do_sample", True),
                   kv_quant=kv_quant, batch_cap=batch_cap,
                   shared_prefix=shared_prefix)

    # ------------------------------------------------------------------
    # host: batching
    # ------------------------------------------------------------------
    def _batch_bucket(self, b_real: int) -> int:
        """Power-of-two batch bucket, capped at the configured batch."""
        b = 1 << (b_real - 1).bit_length()
        if self.batch_cap:
            b = min(b, max(self.batch_cap, b_real))
        return b

    def _shared_split(self, prompts: Sequence[str]):
        """Tokenize and split the batch into (prefix ids, prefix mask, tail
        ids, tail mask) at its common token prefix (at least one tail token
        a row; the prefix left-padded to a 64-multiple), or None for the
        plain program (one prompt, or a prefix under SHARED_PREFIX_MIN)."""
        if not self.shared_prefix or len(prompts) < 2:
            return None
        tok = self.processor.tokenizer
        enc = [np.asarray(tok.encode(p), np.int32) for p in prompts]
        minlen = min(len(e) for e in enc)
        stacked = np.stack([e[:minlen] for e in enc])
        neq = (stacked != stacked[0]).any(axis=0)
        common = minlen if not neq.any() else int(np.argmax(neq))
        common = min(common, minlen - 1)
        if common < self.SHARED_PREFIX_MIN:
            return None
        c_b = _bucket(common)
        pad_id = self.processor.pad_id
        prefix_ids = np.full((1, c_b), pad_id, np.int32)
        prefix_mask = np.zeros((1, c_b), np.int32)
        prefix_ids[0, c_b - common:] = enc[0][:common]
        prefix_mask[0, c_b - common:] = 1
        t_b = _bucket_tail(max(len(e) - common for e in enc))
        tail_ids = np.full((len(enc), t_b), pad_id, np.int32)
        tail_mask = np.zeros((len(enc), t_b), np.int32)
        for i, e in enumerate(enc):
            t = e[common:]
            tail_ids[i, t_b - len(t):] = t
            tail_mask[i, t_b - len(t):] = 1
        return prefix_ids, prefix_mask, tail_ids, tail_mask

    def _pad_rows(self, *arrays: np.ndarray, b_real: int):
        """Repeat each array's last row up to the batch bucket."""
        reps = self._batch_bucket(b_real) - b_real
        return [np.concatenate([a, np.repeat(a[-1:], reps, 0)]) if reps else a
                for a in arrays]

    def _to_device(self, ids: np.ndarray, mask: np.ndarray):
        return (torch.as_tensor(ids, dtype=torch.long, device=self.device),
                torch.as_tensor(mask, dtype=torch.int32, device=self.device))

    # ------------------------------------------------------------------
    # device: the two programs and their decode loop
    # ------------------------------------------------------------------
    def _generate(self, tokens, attn_mask, generator):
        """Plain program (``ospo_tpu/engine/text_engine.py:165-188``)."""
        params, cfg = self.model.params, self.model.cfg
        b, t_prompt = tokens.shape
        kv = janus_lib.init_kv_cache(params, cfg, b,
                                     t_prompt + self.max_new_tokens,
                                     quantized=self.kv_quant,
                                     device=self.device)
        hidden, kv = janus_lib.language_forward(
            params, cfg, janus_lib.embed_text(params, tokens), attn_mask,
            llama.positions_from_mask(attn_mask), kv_cache=kv, self_attn=True)
        return self._decode_loop(kv, hidden, attn_mask.sum(dim=-1), attn_mask,
                                 generator)

    def _generate_shared(self, prefix_ids, prefix_mask, tail_ids, tail_mask,
                         generator):
        """Shared-prefix program (:190-239): the prefix prefills at B = 1
        into a bf16 cache whatever ``kv_quant`` says; the per-row cache
        holds tail + new rows; tail positions continue after the prefix."""
        params, cfg = self.model.params, self.model.cfg
        b, t_tail = tail_ids.shape
        pkv = janus_lib.init_kv_cache(params, cfg, 1, prefix_ids.shape[1],
                                      device=self.device)
        _, pkv = janus_lib.language_forward(
            params, cfg, janus_lib.embed_text(params, prefix_ids), prefix_mask,
            llama.positions_from_mask(prefix_mask), kv_cache=pkv, self_attn=True)
        prefix = {"k": pkv["k"][:, :, :, 0], "v": pkv["v"][:, :, :, 0],
                  "mask": prefix_mask}                   # [L, C, H, Dh] x2
        prefix_len = prefix_mask.sum()
        kv = janus_lib.init_kv_cache(params, cfg, b,
                                     t_tail + self.max_new_tokens,
                                     quantized=self.kv_quant,
                                     device=self.device)
        hidden, kv = janus_lib.language_forward(
            params, cfg, janus_lib.embed_text(params, tail_ids), tail_mask,
            prefix_len + llama.positions_from_mask(tail_mask), kv_cache=kv,
            self_attn=True, prefix_kv=prefix)
        return self._decode_loop(kv, hidden, prefix_len + tail_mask.sum(dim=-1),
                                 tail_mask, generator, prefix=prefix)

    def _decode_loop(self, kv, hidden, prompt_len, prompt_mask, generator,
                     prefix=None):
        """Per-row eos tracking, an eos-filled [B, max_new] buffer on the
        device, early exit once every row has finished (:241-287)."""
        params, cfg = self.model.params, self.model.cfg
        b, max_new = hidden.shape[0], self.max_new_tokens
        eos = self.processor.tokenizer.eos_id
        window_mask = torch.cat([prompt_mask, torch.ones(
            (b, max_new), dtype=prompt_mask.dtype, device=self.device)], dim=-1)
        out = torch.full((b, max_new), eos, dtype=torch.long, device=self.device)
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        hook = self.step_hook
        for step in range(max_new):
            if step:
                if step % self.EOS_CHECK_EVERY == 0 and bool(done.all()):
                    break
                hidden, kv = janus_lib.language_forward(
                    params, cfg, janus_lib.embed_text(params, tok[:, None]),
                    window_mask, (prompt_len + step - 1)[:, None], kv_cache=kv,
                    prefix_kv=prefix)
            if hook:
                hook(step)
            logits = janus_lib.lm_logits(params, hidden[:, -1:])[:, 0]
            tok = sample_token(logits, generator, temperature=self.temperature,
                               top_p=self.top_p, do_sample=self.do_sample)
            tok = torch.where(done, torch.full_like(tok, eos), tok)
            # under tensor parallel every rank feeds (and tests for eos)
            # model rank 0's ids
            tok = mesh_lib.broadcast_model(tok)
            out[:, step] = tok
            done = done | (tok == eos)
        return out

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate_ids(self, prompts: Sequence[str], seed: Optional[int] = None,
                     generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Prompt strings → generated ids [B, max_new_tokens] int32
        (eos-filled).  Sampling draws from ``generator``, else from a new
        one seeded with ``seed`` (default 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0 if seed is None else int(seed))
        b_real = len(prompts)
        split = self._shared_split(prompts)
        if split is not None:
            prefix_ids, prefix_mask, tail_ids, tail_mask = split
            tail_ids, tail_mask = self._pad_rows(tail_ids, tail_mask,
                                                 b_real=b_real)
            out = self._generate_shared(
                *self._to_device(prefix_ids, prefix_mask),
                *self._to_device(tail_ids, tail_mask), generator)
        else:
            ids, mask = self.processor.encode_batch_left_padded(prompts)
            pad = _bucket_tail(ids.shape[1]) - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (pad, 0)),
                         constant_values=self.processor.pad_id)
            mask = np.pad(mask, ((0, 0), (pad, 0)))
            ids, mask = self._pad_rows(ids, mask, b_real=b_real)
            out = self._generate(*self._to_device(ids, mask), generator)
        return out[:b_real].cpu().numpy().astype(np.int32)

    def generate(self, prompts: Sequence[str], seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> List[str]:
        """Prompt strings → decoded generations (special tokens stripped,
        cut at the first eos)."""
        tok = self.processor.tokenizer
        out = []
        for row in self.generate_ids(prompts, seed=seed, generator=generator):
            row = row.tolist()
            if tok.eos_id in row:
                row = row[: row.index(tok.eos_id)]
            out.append(tok.decode(row, skip_special_tokens=True))
        return out
