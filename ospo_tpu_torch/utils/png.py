"""A minimal PNG codec on ``zlib`` and ``struct``, so the pipeline needs no
imaging package.

:func:`write_png` writes a valid, non-interlaced 8-bit truecolour PNG
(filter 0 on every row).  :func:`read_png` decodes any 8-bit non-interlaced
PNG of colour type 0 (grey), 2 (RGB) or 6 (RGBA) with the five row filters
(None, Sub, Up, Average, Paeth), as PIL writes them, and returns RGB: grey
is replicated, alpha is dropped (PIL's ``convert("RGB")``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type → samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] → PNG bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png wants uint8 [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # leading 0 = filter "None"
    raw[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo one scanline's filter (PNG spec section 9); uint8 in and out."""
    if ftype == 0:
        return row
    if ftype == 2:  # Up
        return row + prior
    if ftype == 1:  # Sub: a running sum per byte lane, modulo 256
        lanes = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).reshape(-1)
    if ftype not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ftype}")
    # Average and Paeth depend on the decoded byte to the left: a byte loop
    out = row.tolist()
    up = prior.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes → uint8 [H, W, 3]."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG")
    pos, idat, w, h, ctype = 8, [], 0, 0, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{name}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or ctype not in _CHANNELS or interlace:
                raise ValueError(
                    f"{name}: bit depth {depth}, colour type {ctype}, "
                    f"interlace {interlace}; read_png takes 8-bit "
                    "non-interlaced grey, RGB or RGBA")
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if ctype is None:
        raise ValueError(f"{name}: no IHDR chunk")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, bpp)
    img = out.reshape(h, w, bpp)
    if ctype == 0:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_png(path: str) -> np.ndarray:
    """PNG file → uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)
