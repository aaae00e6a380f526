"""A plain PNG codec (8-bit RGB, non-interlaced) on ``zlib``.

``encode`` writes the benchmark's input images; ``decode`` reads back what
the program wrote, any of the five row filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode(img: np.ndarray, level: int = 1) -> bytes:
    h, w, c = img.shape
    if img.dtype != np.uint8 or c != 3:
        raise ValueError(f"encode wants uint8 [H, W, 3], got {img.dtype} {img.shape}")
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit, colour type 2) → uint8 [H, W, 3]."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, w = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or ctype != 2 or interlace:
                raise ValueError(f"unsupported PNG: depth {depth} type {ctype}")
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 3 * w
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prior) & 255
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - 3] if x >= 3 else 0
                c = prior[x - 3] if x >= 3 else 0
                pred = {1: a, 3: (a + prior[x]) // 2,
                        4: _paeth(a, prior[x], c)}[int(ftype)]
                cur[x] = (line[x] + pred) & 255
        out[y] = cur
        prior = cur
    return out.astype(np.uint8).reshape(h, w, 3)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def write(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))
