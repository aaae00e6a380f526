"""Handing the benchmark's weights to the program under test.

The program loads a Janus-Pro checkpoint through its own checkpoint porting
(``ospo_tpu_torch.models.weights.load_janus``: key map, quantization, the
key-coverage audit).  A 7B checkpoint on disk would be 15 GB written in
every run, so the tensors are fed from memory: the loader's shard reader is
swapped, for the length of one load, for a reader over the dict that
``harness.weights`` made.  That reader hands out copies, as a file reader
would, so nothing the program later does to its weights reaches the dict.
The configuration itself goes through the program's own ``config.json``
parser from a small file under the run's scratch directory.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict

import torch


class MemoryCheckpoint:
    """The interface of the loader's shard reader, over a dict of tensors."""

    def __init__(self, tensors: Dict[str, torch.Tensor], device):
        self._tensors = tensors
        self.device = device
        self.consumed: set = set()

    def keys(self):
        return self._tensors.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._tensors

    def get(self, key: str, dtype=None) -> torch.Tensor:
        self.consumed.add(key)
        t = self._tensors[key]
        return t.to(device=self.device, dtype=dtype or t.dtype, copy=True)


@contextlib.contextmanager
def _memory_reader(tensors):
    from ospo_tpu_torch.models import weights as port_weights

    saved = port_weights._Checkpoint
    port_weights._Checkpoint = lambda path, device: MemoryCheckpoint(tensors, device)
    try:
        yield port_weights
    finally:
        port_weights._Checkpoint = saved


def write_config(cfg: dict, directory: str) -> str:
    """The configuration's HF fields as ``config.json`` under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    hf = {k: v for k, v in cfg.items()
          if k not in ("source", "reduced", "assumed", "why")}
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf, f)
    return directory


def load_model(cfg: dict, tensors: Dict[str, torch.Tensor], scratch: str,
               device, quantize: str = "", understanding: bool = False,
               vision: bool = True, lm_head: bool = False):
    """The program's ``JanusModel`` from the in-memory checkpoint."""
    path = write_config(cfg, os.path.join(scratch, "model"))
    with _memory_reader(tensors) as port_weights:
        return port_weights.load_janus(
            path, device=device, quantize=quantize, lm_head=lm_head,
            vision=vision, understanding=understanding)


def processor_for(model, cfg: dict):
    """The program's processor as its model factory builds it for a
    checkpoint without tokenizer files (the byte tokenizer), with the
    configuration's ``preprocessor_config``."""
    from ospo_tpu_torch.image_processing import ImageProcessor
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import load_tokenizer

    pc = cfg["preprocessor_config"]
    tok = load_tokenizer(None, vocab_size=model.cfg.language.vocab_size)
    image = ImageProcessor(image_size=pc["image_size"], image_mean=pc["image_mean"],
                           image_std=pc["image_std"],
                           rescale_factor=pc["rescale_factor"])
    return Processor(tok, image, num_image_tokens=model.cfg.num_image_tokens)
