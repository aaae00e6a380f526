"""Prompt processor — the part of ``ospo_tpu/processing.py`` that steps 3
and 5 use: the tokenizer, the image processor (set by ``get_model`` from the
checkpoint's preprocessor config, or the defaults at the model's size) and
the text-to-image prompt."""

from __future__ import annotations

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


def t2i_prompt(processor: Processor, prompt: str) -> str:
    """Text-to-image prompt: bare-role SFT format, empty system prompt,
    ``<begin_of_image>`` appended (ospo/wrapper/image_generation.py:100-106)."""
    sft = chat.apply_sft_template(chat.t2i_conversation(prompt), system_prompt="")
    return sft + processor.image_start_tag
