"""Image file IO for outputs and golden tests.

PNG is written and read here with the standard library (``zlib``), so
rendering a frame to disk and checking it against a golden needs no image
package. Other formats (JPEG textures, interlaced PNGs) go through Pillow,
imported only when such a file is read.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def to_u8(img) -> np.ndarray:
    """[0,1] float image -> uint8."""
    a = np.asarray(img)
    return np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """(H, W), (H, W, 1|2|3|4) image -> PNG bytes (8-bit; floats are taken
    as [0, 1]). Every row uses the Up filter."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = to_u8(a)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.ascontiguousarray(a).reshape(h, w * c)
    filtered = rows.copy()
    filtered[1:] -= rows[:-1]  # uint8 arithmetic wraps, as PNG's does
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), filtered], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: (h * (1 + stride),) -> (h, stride)."""
    rows = raw.reshape(h, 1 + stride)
    kinds, data = rows[:, 0], rows[:, 1:]
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f = data[y]
        k = kinds[y]
        if k == 0:
            cur = f.copy()
        elif k == 1:  # Sub: running sum along the row, per byte of a pixel
            cur = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif k == 2:  # Up
            cur = f + prev
        elif k in (3, 4):  # Average, Paeth: each pixel needs its left one
            cur = np.zeros(stride, np.uint8)
            up = prev.astype(np.int32)
            for x in range(0, stride, bpp):
                b = up[x:x + bpp]
                a = (cur[x - bpp:x].astype(np.int32) if x
                     else np.zeros(bpp, np.int32))
                if k == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (f[x:x + bpp].astype(np.int32) + pred) & 0xFF
        else:
            raise ValueError(f"PNG: bad filter type {k}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray | None:
    """PNG bytes -> (H, W, C) uint8, C = 1 (grey), 2 (grey + alpha), 3 or 4.
    Palette images come back as RGB(A). Returns None for what this decoder
    does not read (interlaced, or palette/grey below 8 bits)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, palette, trns = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if interlace or depth not in (8, 16):
        return None
    c = _CHANNELS[ctype]
    bpp = c * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * bpp, bpp).reshape(h, w, bpp)
    if depth == 16:
        px = px[..., 0::2]  # keep the high byte
    if ctype == 3:
        lut = palette
        if trns is not None:
            alpha = np.full((len(palette), 1), 255, np.uint8)
            alpha[:len(trns), 0] = trns
            lut = np.concatenate([palette, alpha], axis=1)
        px = lut[px[..., 0]]
    return np.ascontiguousarray(px)


def load_image_rgba(path: str) -> np.ndarray:
    """Load an image file as (H, W, 4) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    px = decode_png(data) if data[:8] == _PNG_SIGNATURE else None
    if px is None:
        import io

        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGBA"))
    h, w, c = px.shape
    if c in (1, 2):
        px = np.concatenate([np.repeat(px[..., :1], 3, axis=-1), px[..., 1:]], -1)
    if px.shape[-1] == 3:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    return px
