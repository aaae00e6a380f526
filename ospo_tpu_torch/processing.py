"""Prompt processor — the part of ``ospo_tpu/processing.py`` that steps 1
to 3 and 5 use: the tokenizer, the image processor (set by ``get_model``
from the checkpoint's preprocessor config, or the defaults at the model's
size), left-padded text batches and the text-to-image prompt."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ospo_tpu_torch import chat
from ospo_tpu_torch.constants import IMAGE_START_TAG
from ospo_tpu_torch.image_processing import ImageProcessor
from ospo_tpu_torch.tokenizer import BaseTokenizer


class Processor:
    image_start_tag = IMAGE_START_TAG

    def __init__(self, tokenizer: BaseTokenizer, image_processor=None):
        self.tokenizer = tokenizer
        self.image_processor = image_processor or ImageProcessor()

    @property
    def pad_id(self) -> int:
        return self.tokenizer.pad_id

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
