"""PNG writer on the standard library (zlib + struct), for machines without
PIL: 8-bit RGB (H, W, 3) uint8, 8-bit grey (H, W) uint8 and 16-bit grey
(H, W) uint16. Rows are stored unfiltered."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_FORMATS = {  # (dtype, ndim) -> (bit depth, colour type)
    (np.dtype(np.uint8), 3): (8, 2),
    (np.dtype(np.uint8), 2): (8, 0),
    (np.dtype(np.uint16), 2): (16, 0),
}


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
