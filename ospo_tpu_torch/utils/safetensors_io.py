"""The safetensors format, read and written without the ``safetensors``
package.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
(``{"__metadata__": {str: str}, name: {"dtype", "shape", "data_offsets"}}``,
padded with spaces to a multiple of 8), then the tensors' raw little-endian
bytes, each at ``data_offsets`` relative to the end of the header.

:class:`SafeOpen` reads a file lazily: the header once, the data through a
copy-on-write ``numpy.memmap``, and each tensor as a ``torch.from_numpy``
view of its bytes, so a checkpoint directory is never copied whole into host
memory.  :func:`save_file` writes what ``safetensors.torch.save_file``
writes, byte for byte: tensors ordered by dtype (the package's dtype order,
largest first) and then by name, compact JSON, the header padded with
spaces.  With more than one metadata key the package's order is a hash
order, so byte equality holds for at most one.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

# format name → (numpy dtype of the bytes, torch dtype of the tensor)
DTYPES = {
    "BOOL": (np.dtype(np.bool_), torch.bool),
    "U8": (np.dtype("<u1"), torch.uint8),
    "I8": (np.dtype("<i1"), torch.int8),
    "I16": (np.dtype("<i2"), torch.int16),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<i2"), torch.bfloat16),   # bits, viewed as bf16
    "I32": (np.dtype("<i4"), torch.int32),
    "F32": (np.dtype("<f4"), torch.float32),
    "F64": (np.dtype("<f8"), torch.float64),
    "I64": (np.dtype("<i8"), torch.int64),
}
# the package's dtype order (its Rust enum); the writer sorts largest first
_ORDER = {name: i for i, name in enumerate(DTYPES)}
_NAMES = {tdt: name for name, (_, tdt) in DTYPES.items()}


class SafeOpen:
    """``keys()`` and ``get_tensor(key)`` over one ``.safetensors`` file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self._meta = header.pop("__metadata__", None)
        self._header = header
        self._start = 8 + n
        size = os.path.getsize(path)
        # mode "c": writable views whose writes stay private to the process
        self._data = (np.memmap(path, dtype=np.uint8, mode="c")
                      if size > self._start else np.zeros(0, np.uint8))
        self.path = path

    def keys(self) -> List[str]:
        return sorted(self._header)

    def metadata(self) -> Optional[Dict[str, str]]:
        return self._meta

    def get_tensor(self, key: str) -> torch.Tensor:
        info = self._header[key]
        try:
            np_dt, torch_dt = DTYPES[info["dtype"]]
        except KeyError:
            raise ValueError(f"{self.path}: {key} has dtype {info['dtype']}, "
                             f"not one of {sorted(DTYPES)}") from None
        begin, end = (self._start + o for o in info["data_offsets"])
        raw = self._data[begin:end]
        if begin % np_dt.itemsize:
            raw = raw.copy()  # a view must be aligned to its element
        t = torch.from_numpy(raw.view(np_dt).reshape(info["shape"]))
        return t.view(torch_dt) if t.dtype != torch_dt else t


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (CPU or device; copied to the host one at a time)
    as one ``.safetensors`` file."""
    def rank(item):
        return -_ORDER[_NAMES[item[1].dtype]], item[0]

    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} is not written "
                             f"(one of {sorted(DTYPES)})")
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = metadata
    ordered = sorted(tensors.items(), key=rank)
    offset = 0
    for name, t in ordered:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":"),
                      ensure_ascii=False).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for _, t in ordered:
            t = t.detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().data)
