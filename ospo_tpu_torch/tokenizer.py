"""Tokenizer layer (copy of ``ospo_tpu/tokenizer.py``).

Two interchangeable backends behind one small interface:

- :class:`HFTokenizer` — wraps a HuggingFace ``tokenizers.Tokenizer`` loaded
  from a Janus-Pro checkpoint directory (``tokenizer.json``); the production
  path (the reference loads ``LlamaTokenizerFast`` from the same files).
- :class:`ByteTokenizer` — a self-contained deterministic byte-level BPE-free
  tokenizer used by tests and tiny-model runs when no checkpoint is on disk.

Both expose: ``encode`` (prepends BOS like the reference's Llama tokenizer),
``decode``, ``vocab`` (surface→id mapping, so pipeline code can do
``tokenizer.vocab.get("<image_placeholder>")`` exactly like the reference,
e.g. ``ospo/wrapper/image_generation.py:26-29``), and the special-token id
properties the processor layer needs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from ospo_tpu_torch.constants import (
    BOS_TAG,
    EOS_TAG,
    IMAGE_END_TAG,
    IMAGE_START_TAG,
    IMAGE_TAG,
    PAD_TAG,
)

SPECIAL_TAGS = (BOS_TAG, EOS_TAG, PAD_TAG, IMAGE_TAG, IMAGE_START_TAG, IMAGE_END_TAG)


class BaseTokenizer:
    """Shared special-token plumbing."""

    vocab: Dict[str, int]

    @property
    def bos_id(self) -> int:
        return self.vocab[BOS_TAG]

    @property
    def eos_id(self) -> int:
        return self.vocab[EOS_TAG]

    @property
    def pad_id(self) -> int:
        return self.vocab[PAD_TAG]

    @property
    def image_id(self) -> int:
        return self.vocab[IMAGE_TAG]

    @property
    def image_start_id(self) -> int:
        return self.vocab[IMAGE_START_TAG]

    @property
    def image_end_id(self) -> int:
        return self.vocab[IMAGE_END_TAG]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raise NotImplementedError


class ByteTokenizer(BaseTokenizer):
    """Deterministic UTF-8 byte tokenizer with registered special tags.

    Layout: ids 0..255 = raw bytes; specials follow in :data:`SPECIAL_TAGS`
    order.  ``vocab_size`` pads the id space up to a lane-aligned size so a
    tiny LM head stays MXU-friendly.
    """

    def __init__(self, vocab_size: int = 512):
        n_special = len(SPECIAL_TAGS)
        assert vocab_size >= 256 + n_special
        self.vocab_size = vocab_size
        self.vocab = {chr(b): b for b in range(256)}
        self._specials: Dict[str, int] = {}
        for i, tag in enumerate(SPECIAL_TAGS):
            tid = 256 + i
            self.vocab[tag] = tid
            self._specials[tag] = tid
        self._special_ids = set(self._specials.values())
        # longest-first so overlapping tags match greedily
        self._tags_by_len = sorted(self._specials, key=len, reverse=True)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        i = 0
        while i < len(text):
            matched = False
            for tag in self._tags_by_len:
                if text.startswith(tag, i):
                    ids.append(self._specials[tag])
                    i += len(tag)
                    matched = True
                    break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        inv = {v: k for k, v in self._specials.items()}
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            nonlocal byte_buf
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf = bytearray()

        for i in ids:
            i = int(i)
            if i < 256:
                byte_buf.append(i)
            elif i in inv:
                flush()
                if not skip_special_tokens:
                    out.append(inv[i])
            # padded / out-of-range ids are dropped
        flush()
        return "".join(out)


class HFTokenizer(BaseTokenizer):
    """Production tokenizer backed by ``tokenizers.Tokenizer``.

    Loads ``tokenizer.json`` from a Janus-Pro checkpoint dir and registers
    the multimodal special tags if absent (the reference adds
    ``<image_placeholder>`` the same way, ``processing_vlm.py:102-107``).
    """

    def __init__(self, path: str):
        from tokenizers import AddedToken, Tokenizer

        tok_file = path if path.endswith(".json") else os.path.join(path, "tokenizer.json")
        self._tok = Tokenizer.from_file(tok_file)
        missing = [t for t in SPECIAL_TAGS if self._tok.token_to_id(t) is None]
        if missing:
            self._tok.add_special_tokens(
                [AddedToken(t, special=True, normalized=False) for t in missing]
            )
        self.vocab = self._tok.get_vocab()
        self.vocab_size = self._tok.get_vocab_size()
        self._special_ids = {self.vocab[t] for t in SPECIAL_TAGS if t in self.vocab}

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_bos:
            return [self.bos_id] + list(ids)
        return list(ids)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=skip_special_tokens)


def load_tokenizer(model_path: Optional[str], vocab_size: int = 512) -> BaseTokenizer:
    """Load the HF tokenizer from ``model_path`` when available, else fall
    back to the deterministic byte tokenizer (tiny/test runs)."""
    if model_path:
        if model_path.endswith(".json") and os.path.isfile(model_path):
            return HFTokenizer(model_path)
        if os.path.isdir(model_path):
            if os.path.isfile(os.path.join(model_path, "tokenizer.json")):
                return HFTokenizer(model_path)
            cfg_path = os.path.join(model_path, "config.json")
            synthetic = False
            if os.path.isfile(cfg_path):
                try:
                    import json

                    with open(cfg_path) as f:
                        synthetic = bool(json.load(f).get("ospo_synthetic"))
                except Exception:
                    pass
            if synthetic:  # dress-rehearsal checkpoints carry no tokenizer
                print(f"# synthetic checkpoint {model_path}: byte tokenizer")
                return ByteTokenizer(vocab_size=vocab_size)
            # a real checkpoint dir WITHOUT its tokenizer must fail loudly:
            # byte-tokenizing prompts against a 102400-vocab embedding
            # produces garbage generation with zero diagnostics
            raise FileNotFoundError(
                f"{model_path} has no tokenizer.json — a real checkpoint "
                "dir must ship its tokenizer (the byte fallback is only "
                "for tokenizer-less tiny/synthetic runs)")
    return ByteTokenizer(vocab_size=vocab_size)
