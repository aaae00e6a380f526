"""CFG image-token decode engine (step 3) — counterpart of
``ospo_tpu/engine/image_engine.py``.

- cond/uncond pairs are one fused batch of 2B rows ([0:B] cond, [B:2B]
  uncond);
- the prompt prefill runs once through the flash kernel into a preallocated
  batch-minor KV cache, then 576 image tokens are decoded one step at a
  time, each step reading the cache with the decode-attention kernel;
- the CFG combine ``uncond + w·(cond − uncond)``, temperature and sampling
  run in fp32; the sampled token is fed back through gen_embed → gen_aligner;
- ``decode_code`` turns the tokens into uint8 pixels on the device.

This is what the JAX engine does with ``decode_kernel: true``: the cache
window is 64-aligned and always the whole cache (the kernel reads only the
populated prefix).  The step-3 config keys ``decode_kernel`` and
``decode_segments`` therefore select nothing here and are not read.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ospo_tpu_torch.constants import (IMAGE_TOKEN_NUM_PER_IMAGE, IMG_SIZE,
                                      PATCH_SIZE)
from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import llama, vqgan
from ospo_tpu_torch.ops.quant import parse_kv_quant
from ospo_tpu_torch.ops.sampling import sample_categorical
from ospo_tpu_torch.processing import Processor, t2i_prompt


def _bucket(n: int, step: int = 64) -> int:
    return max(step, ((n + step - 1) // step) * step)


class ImageGenEngine:
    def __init__(
        self,
        model: janus_lib.JanusModel,
        processor: Processor,
        cfg_weight: float = 5.0,
        temperature: float = 1.0,
        image_token_num: int = IMAGE_TOKEN_NUM_PER_IMAGE,
        img_size: int = IMG_SIZE,
        patch_size: int = PATCH_SIZE,
        kv_quant=False,
        speculative: int = 0,
        kv_layout: str = None,
        batch_cap: int = None,
    ):
        self.model = model
        self.device = model.device
        self.processor = processor
        self.cfg_weight = float(cfg_weight)
        self.temperature = float(temperature)
        self.image_token_num = image_token_num
        self.img_size = img_size
        self.patch_size = patch_size
        self.kv_quant = parse_kv_quant(kv_quant)
        if self.kv_quant == "int4":
            raise NotImplementedError(
                "kv_quant: int4 is queued in ROADMAP.md (slice 5, opt-in modes)")
        if int(speculative):
            raise NotImplementedError(
                "speculative Jacobi decoding is queued in ROADMAP.md "
                "(slice 5, opt-in modes)")
        self.kv_layout = kv_layout or "shbd"
        if self.kv_layout != "shbd":
            raise NotImplementedError(
                f"kv_layout {self.kv_layout!r}: the port has the batch-minor "
                "'shbd' cache only; 'bshd'/'bhsd' are queued in ROADMAP.md "
                "(slice 5, opt-in modes)")
        self.batch_cap = batch_cap
        # step_hook(step) is called on the host before each step's emit
        # (step 0 right after the prefill); scripts/profile_torch_step3.py
        # times and profiles the serving loop through it
        self.step_hook = None

    # ------------------------------------------------------------------
    # prompt construction (host)
    # ------------------------------------------------------------------
    def build_cfg_batch(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenise prompts into the fused [2B, T] cond/uncond batch.

        The uncond rows set every prompt token to ``<pad>`` except the first
        (BOS) and last (``<begin_of_image>``), and — the reference's quirk
        (ospo/wrapper/image_generation.py:135-141) — their attention mask
        still covers the pad-masked positions."""
        tok = self.processor.tokenizer
        ids_list = [np.asarray(tok.encode(p), np.int32) for p in prompts]
        t_max = _bucket(max(len(x) for x in ids_list))
        b = len(prompts)
        tokens = np.full((2 * b, t_max), self.processor.pad_id, np.int32)
        mask = np.zeros((2 * b, t_max), np.int32)
        for i, ids in enumerate(ids_list):
            start = t_max - len(ids)
            tokens[i, start:] = ids
            tokens[b + i, start:] = ids
            tokens[b + i, start + 1 : -1] = self.processor.pad_id  # uncond
            mask[i, start:] = 1
            mask[b + i, start:] = 1
        return tokens, mask

    def _batch_bucket(self, b_real: int) -> int:
        """CFG-pair batch bucket: the next power of two, capped at the
        configured serving batch (ragged tails bucket below the cap)."""
        b = 1 << (b_real - 1).bit_length()
        if self.batch_cap:
            b = min(b, max(self.batch_cap, b_real))
        return b

    # ------------------------------------------------------------------
    # decode loop
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _segmented_decode(self, tokens: torch.Tensor, attn_mask: torch.Tensor,
                          step_fn: Callable) -> torch.Tensor:
        """The serving loop shared by sampling and the teacher-forced probe:
        prefill into the KV cache, then ``n_img - 1`` cached steps.
        ``step_fn(hidden_last, step, prompt_len) → (emit, embeds, pos)``
        defines what each step emits and feeds next; emits are stacked on
        axis 1."""
        params, cfg = self.model.params, self.model.cfg
        two_b, t_prompt = tokens.shape
        n_img = self.image_token_num
        s_max = ((t_prompt + n_img + 63) // 64) * 64

        kv = llama.init_kv_cache(cfg.language, two_b, s_max,
                                 quantized=self.kv_quant, layout=self.kv_layout,
                                 device=self.device)
        hidden, kv = janus_lib.language_forward(
            params, cfg, janus_lib.embed_text(params, tokens), attn_mask,
            llama.positions_from_mask(attn_mask), kv_cache=kv, self_attn=True)
        prompt_len = attn_mask.sum(dim=-1)           # [2B] valid prompt tokens

        # mask over the whole cache: prompt part, all-ones image part
        # (cur_len excludes rows not written yet), zero alignment pad
        window_mask = torch.cat([
            attn_mask,
            torch.ones((two_b, n_img), dtype=torch.int32, device=self.device),
            torch.zeros((two_b, s_max - t_prompt - n_img), dtype=torch.int32,
                        device=self.device)], dim=-1).contiguous()

        hook = self.step_hook
        if hook:
            hook(0)
        emit, embeds, pos = step_fn(hidden[:, -1], 0, prompt_len)
        outs = [emit]
        for step in range(1, n_img):
            hidden, kv = janus_lib.language_forward(
                params, cfg, embeds, window_mask, pos, kv_cache=kv)
            if hook:
                hook(step)
            emit, embeds, pos = step_fn(hidden[:, -1], step, prompt_len)
            outs.append(emit)
        return torch.stack(outs, dim=1)

    def _cfg_logits(self, hidden_last: torch.Tensor, cfg_weight: float):
        logits = janus_lib.gen_logits(self.model.params, hidden_last[:, None, :])[:, 0]
        b = logits.shape[0] // 2
        cond, uncond = logits[:b], logits[b:]
        return (uncond + cfg_weight * (cond - uncond)).float()

    def _feed(self, tok: torch.Tensor, step: int, prompt_len: torch.Tensor):
        both = torch.cat([tok, tok])                           # [2B]
        embeds = janus_lib.prepare_gen_img_embeds(
            self.model.params, self.model.cfg, both[:, None])
        return embeds, (prompt_len + step)[:, None]            # pos [2B, 1]

    def _generate_tokens(self, tokens, attn_mask, generator: torch.Generator):
        def sample_step(hidden_last, step, prompt_len):
            fused = self._cfg_logits(hidden_last, self.cfg_weight)
            tok = sample_categorical(fused, self.temperature, generator)
            return (tok, *self._feed(tok, step, prompt_len))

        return self._segmented_decode(tokens, attn_mask, sample_step)

    def forced_cfg_logits(self, prompts: Sequence[str],
                          forced_tokens: np.ndarray) -> np.ndarray:
        """Teacher-forced CFG decode: the same serving loop, fed the given
        image tokens [B, n_img] instead of samples; returns the fused fp32
        CFG logits at every step [B, n_img, V] (the parity probe)."""
        tokens, mask = self._to_device(*self.build_cfg_batch(list(prompts)))
        forced = torch.as_tensor(np.asarray(forced_tokens), dtype=torch.long,
                                 device=self.device)

        def forced_step(hidden_last, step, prompt_len):
            fused = self._cfg_logits(hidden_last, self.cfg_weight)
            return (fused, *self._feed(forced[:, step], step, prompt_len))

        return self._segmented_decode(tokens, mask, forced_step).cpu().numpy()

    def _to_device(self, tokens: np.ndarray, mask: np.ndarray):
        return (torch.as_tensor(tokens, dtype=torch.long, device=self.device),
                torch.as_tensor(mask, dtype=torch.int32, device=self.device))

    @torch.inference_mode()
    def _decode_tokens(self, gen_tokens: torch.Tensor) -> torch.Tensor:
        latent = self.img_size // self.patch_size
        pixels = vqgan.decode_code(self.model.params["gen_vision_model"],
                                   self.model.cfg.vq, gen_tokens,
                                   latent_hw=(latent, latent))
        # uint8 on the device (the reference's np.clip((dec+1)/2*255, 0,
        # 255), image_generation.py:177); the cast truncates
        return ((pixels.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def _generate_tokens_device(self, prompts: Sequence[str], seed: int = 0):
        """Bucketed generation, left on the device → (tokens [b_bucket,
        n_img], b_real); rows past b_real are padding duplicates."""
        b_real = len(prompts)
        prompts = list(prompts) + [prompts[-1]] * (self._batch_bucket(b_real) - b_real)
        tokens, mask = self._to_device(*self.build_cfg_batch(prompts))
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(seed))
        return self._generate_tokens(tokens, mask, generator), b_real

    def generate_tokens(self, prompts: Sequence[str], seed: int = 0) -> np.ndarray:
        """Prompts → sampled image tokens [B, n_img] on the host, without
        the VQ decode (what ``python -m ospo_tpu_torch.bench`` times)."""
        toks, b_real = self._generate_tokens_device(prompts, seed=seed)
        return toks[:b_real].cpu().numpy()

    def generate_images_device(self, prompts: Sequence[str],
                               seed: int = 0) -> torch.Tensor:
        """T2I-formatted prompts → uint8 [b_bucket, H, W, 3] on the device,
        without a host sync; rows past ``len(prompts)`` are padding."""
        toks, _ = self._generate_tokens_device(prompts, seed=seed)
        return self._decode_tokens(toks)

    def generate_images(self, prompts: Sequence[str], seed: int = 0) -> np.ndarray:
        """T2I-formatted prompts → uint8 images [B, H, W, 3] on the host."""
        imgs = self.generate_images_device(prompts, seed=seed)
        return imgs[: len(prompts)].cpu().numpy()

    def generate_from_raw_prompts(self, raw_prompts: Sequence[str],
                                  seed: int = 0) -> np.ndarray:
        """Raw prompts → uint8 images [B, H, W, 3] on the host, each prompt
        wrapped in the T2I template first (the inference CLI's entry)."""
        return self.generate_images(
            [t2i_prompt(self.processor, p) for p in raw_prompts], seed=seed)
