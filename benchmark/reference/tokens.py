"""Prompt → token ids, worked out from the published formats.

Janus-Pro's text-to-image prompt is the bare-role SFT conversation with an
empty system prompt, ``"User: {prompt}\\n\\nAssistant:"``, stripped, with
``<begin_of_image>`` appended; the tokenizer prepends BOS.  The card has no
BPE tokenizer, so ids are the byte-level stand-in the configurations state
under ``assumed``: bytes 0-255, then the special tags in a fixed order.
"""

from __future__ import annotations

from typing import List

SPECIALS = ("<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>", "<｜▁pad▁｜>",
            "<image_placeholder>", "<begin_of_image>", "<end_of_image>")
BOS, EOS, PAD, IMAGE, IMAGE_START, IMAGE_END = range(256, 262)


def t2i_ids(prompt: str) -> List[int]:
    text = f"User: {prompt.strip()}\n\nAssistant:".strip()
    return [BOS, *text.encode("utf-8"), IMAGE_START]


def uncond_ids(ids: List[int]) -> List[int]:
    """The CFG unconditional row: every token but the first and the last
    replaced by the pad id."""
    return [ids[0]] + [PAD] * (len(ids) - 2) + [ids[-1]]
