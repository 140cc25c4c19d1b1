"""PNG reader and writer on the standard library (zlib + struct) and numpy,
for machines without PIL.

`write_png` writes 8-bit RGB (H, W, 3) uint8, 8-bit grey (H, W) uint8 and
16-bit grey (H, W) uint16, rows unfiltered. `read_png` reads what
KITTI-360 and PIL write: colour types 0 (grey, 8 or 16 bit), 2 (RGB) and
6 (RGBA) at 8 bits, non-interlaced, with any of the five scanline filters;
it returns the array `np.asarray(PIL.Image.open(path))` gives. Anything
else (palette, interlaced, other bit depths) raises ValueError naming the
file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from panopticnerf_tpu_torch.utils.profiling import span

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_FORMATS = {  # (dtype, ndim) -> (bit depth, colour type)
    (np.dtype(np.uint8), 3): (8, 2),
    (np.dtype(np.uint8), 2): (8, 0),
    (np.dtype(np.uint16), 2): (16, 0),
}
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels read


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    arr = np.asarray(arr)
    key = (arr.dtype, arr.ndim)
    if key not in _FORMATS or (arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W, 3) uint8, (H, W) uint8 or (H, W) uint16, "
                         f"not {arr.shape} {arr.dtype}")
    depth, colour = _FORMATS[key]
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">"))).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.view(np.uint8)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ft: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Filters None, Sub and Up only: row by row, each row vectorised.
    x (H, npx, bpp) uint8 filtered bytes -> reconstructed bytes."""
    out = np.empty_like(x)
    prev = np.zeros_like(x[0])
    for y in range(x.shape[0]):
        if ft[y] == 0:
            out[y] = x[y]
        elif ft[y] == 1:  # Sub: a running sum along the row, per byte of a pixel, mod 256
            out[y] = np.cumsum(x[y], axis=0, dtype=np.uint8)
        else:             # Up
            out[y] = x[y] + prev
        prev = out[y]
    return out


def _unfilter_wavefront(ft: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Every filter type, Average and Paeth included. Pixel (y, p) depends
    on (y, p-1), (y-1, p) and (y-1, p-1), so each anti-diagonal y + p = d
    depends only on the two before it: the loop runs over the H + W - 1
    diagonals, each a vector step over its rows. The image is held skewed,
    pixel (y, p) at s[y + 1, y + p + 2], so that a diagonal's neighbours
    are plain column slices; row 0 and the positions no pixel maps to stay
    zero, which is the PNG rule for the bytes left of and above the image."""
    h, npx, bpp = x.shape
    s = np.zeros((h + 1, h + npx + 2, bpp), np.int32)
    xs = np.zeros((h, h + npx, bpp), np.int32)
    yy, pp = np.meshgrid(np.arange(h), np.arange(npx), indexing="ij")
    xs[yy, yy + pp] = x
    ft = ft.astype(np.int32)[:, None]
    for d in range(h + npx - 1):
        y0, y1 = max(0, d - npx + 1), min(h - 1, d) + 1
        a = s[y0 + 1:y1 + 1, d + 1]      # left
        b = s[y0:y1, d + 1]              # up
        c = s[y0:y1, d]                  # up-left
        t = ft[y0:y1]
        pred = np.where(t == 0, 0, np.where(t == 1, a, np.where(
            t == 2, b, np.where(t == 3, (a + b) >> 1, _paeth(a, b, c)))))
        s[y0 + 1:y1 + 1, d + 2] = (xs[y0:y1, d] + pred) & 0xFF
    return s[yy + 1, yy + pp + 2].astype(np.uint8)


@span("data.decode")
def read_png(path: str) -> np.ndarray:
    """-> (H, W) uint8 or uint16 grey, (H, W, 3) uint8 RGB or (H, W, 4)
    uint8 RGBA, as stored."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, colour, compression, filt, interlace = ihdr
    if colour not in _CHANNELS or not (depth == 8 or (depth == 16 and colour == 0)):
        raise ValueError(f"{path}: PNG colour type {colour} at bit depth {depth} is not "
                         f"supported (grey 8/16 bit, RGB and RGBA at 8 bit are)")
    if compression != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: interlaced or non-standard PNG (compression {compression}, "
                         f"filter method {filt}, interlace {interlace}) is not supported")
    bpp = _CHANNELS[colour] * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (w * bpp + 1):
        raise ValueError(f"{path}: truncated image data")
    rows = raw[:h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    ft, x = rows[:, 0], rows[:, 1:].reshape(h, w, bpp)
    if ft.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown scanline filter type {int(ft.max())}")
    px = (_unfilter_rows if ft.max(initial=0) <= 2 else _unfilter_wavefront)(ft, x)
    if depth == 16:
        return px.reshape(h, w * 2).view(">u2").astype(np.uint16)
    return px[..., 0] if colour == 0 else px
