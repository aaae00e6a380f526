"""Multimodal chat processor — copy of ``ospo_tpu/processing.py``
(``VLChatProcessor``, ``janus/models/processing_vlm.py:72-418``): prompt
rendering, image-token expansion (each ``<image_placeholder>`` becomes
``<begin_of_image>`` + N × ``<image_placeholder>`` + ``<end_of_image>``),
left-padded batches with ``images_seq_mask`` / ``images_emb_mask``, the
left-padded text batches of the text steps and the text-to-image prompt.
The image processor is set by ``get_model`` from the checkpoint's
preprocessor config, or the defaults at the model's size."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ospo_tpu_torch import chat
from ospo_tpu_torch.constants import IMAGE_START_TAG, IMAGE_TOKEN_NUM_PER_IMAGE
from ospo_tpu_torch.image_processing import ImageProcessor
from ospo_tpu_torch.tokenizer import BaseTokenizer


@dataclasses.dataclass
class ProcessorOutput:
    sft_format: str
    input_ids: np.ndarray          # [T] int32, image tokens expanded
    pixel_values: np.ndarray       # [n_images, H, W, 3] float32
    num_image_tokens: List[int]    # per image

    def __len__(self) -> int:
        return len(self.input_ids)


@dataclasses.dataclass
class BatchedOutput:
    sft_format: List[str]
    input_ids: np.ndarray          # [B, T] int32 (left-padded)
    attention_mask: np.ndarray     # [B, T] int32
    pixel_values: np.ndarray       # [B, n, H, W, 3] float32
    images_seq_mask: np.ndarray    # [B, T] bool
    images_emb_mask: np.ndarray    # [B, n, T2] bool


class Processor:
    image_start_tag = IMAGE_START_TAG
    system_prompt = chat.DEFAULT_SYSTEM_PROMPT

    def __init__(self, tokenizer: BaseTokenizer, image_processor=None,
                 num_image_tokens: int = IMAGE_TOKEN_NUM_PER_IMAGE):
        self.tokenizer = tokenizer
        self.image_processor = image_processor or ImageProcessor()
        self.num_image_tokens = num_image_tokens

    @property
    def pad_id(self) -> int:
        return self.tokenizer.pad_id

    @property
    def image_id(self) -> int:
        return self.tokenizer.image_id

    @property
    def image_start_id(self) -> int:
        return self.tokenizer.image_start_id

    @property
    def image_end_id(self) -> int:
        return self.tokenizer.image_end_id

    def expand_image_tokens(self, input_ids: np.ndarray) -> np.ndarray:
        """Each image placeholder → boi + N × img + eoi
        (``add_image_token``, processing_vlm.py:215-258)."""
        span = ([self.image_start_id] + [self.image_id] * self.num_image_tokens
                + [self.image_end_id])
        out: List[int] = []
        for t in input_ids.tolist():
            if t == self.image_id:
                out.extend(span)
            else:
                out.append(t)
        return np.asarray(out, np.int32)

    def process_one(self, prompt: Optional[str] = None,
                    conversations: Optional[Sequence[Dict[str, str]]] = None,
                    images: Sequence = (),
                    system_prompt: Optional[str] = None) -> ProcessorOutput:
        """One prompt string or conversation (rendered with the default
        system prompt unless one is given) → expanded ids and the images'
        float pixels; with no images the ids alone (the image processor does
        not run)."""
        if (prompt is None) == (conversations is None):
            raise ValueError("exactly one of prompt / conversations")
        if prompt is None:
            sft_format = chat.apply_sft_template(
                conversations, system_prompt=self.system_prompt
                if system_prompt is None else system_prompt)
        else:
            sft_format = prompt
        input_ids = np.asarray(self.tokenizer.encode(sft_format), np.int32)
        n_images = int(np.sum(input_ids == self.image_id))
        return ProcessorOutput(
            sft_format=sft_format,
            input_ids=self.expand_image_tokens(input_ids),
            pixel_values=self.image_processor(list(images)),
            num_image_tokens=[self.num_image_tokens] * n_images,
        )

    def batchify(self, prepares: Sequence[ProcessorOutput]) -> BatchedOutput:
        """Left-pad to the longest; ``images_seq_mask`` marks the image
        slots, ``images_emb_mask`` the valid image-embedding rows."""
        bsz, t2 = len(prepares), self.num_image_tokens
        seq_lens = [len(p) for p in prepares]
        n_images = [len(p.num_image_tokens) for p in prepares]
        t_max, n_max = max(seq_lens), max(1, max(n_images))
        input_ids = np.full((bsz, t_max), self.pad_id, np.int32)
        attention_mask = np.zeros((bsz, t_max), np.int32)
        pixel_values = np.zeros((bsz, n_max, *self.image_processor.default_shape),
                                np.float32)
        seq_mask = np.zeros((bsz, t_max), bool)
        emb_mask = np.zeros((bsz, n_max, t2), bool)
        for i, p in enumerate(prepares):
            t = seq_lens[i]
            input_ids[i, -t:] = p.input_ids
            attention_mask[i, -t:] = 1
            seq_mask[i, -t:] = p.input_ids == self.image_id
            if n_images[i] > 0:
                pixel_values[i, :n_images[i]] = p.pixel_values
                for j, n_tok in enumerate(p.num_image_tokens):
                    emb_mask[i, j, :n_tok] = True
        return BatchedOutput(
            sft_format=[p.sft_format for p in prepares], input_ids=input_ids,
            attention_mask=attention_mask, pixel_values=pixel_values,
            images_seq_mask=seq_mask, images_emb_mask=emb_mask)

    def encode_batch_left_padded(self, prompts: Sequence[str]):
        """Prompt strings → (input_ids [B, T] int32, attention_mask [B, T]
        int32), left-padded to the longest (``ospo_tpu/processing.py:180``)."""
        ids_list = [np.asarray(self.tokenizer.encode(p), np.int32) for p in prompts]
        t_max = max(len(x) for x in ids_list)
        input_ids = np.full((len(ids_list), t_max), self.pad_id, np.int32)
        mask = np.zeros((len(ids_list), t_max), np.int32)
        for i, ids in enumerate(ids_list):
            input_ids[i, t_max - len(ids):] = ids
            mask[i, t_max - len(ids):] = 1
        return input_ids, mask


def t2i_prompt(processor: Processor, prompt: str) -> str:
    """Text-to-image prompt: bare-role SFT format, empty system prompt,
    ``<begin_of_image>`` appended (ospo/wrapper/image_generation.py:100-106)."""
    sft = chat.apply_sft_template(chat.t2i_conversation(prompt), system_prompt="")
    return sft + processor.image_start_tag
