"""The port's PNG reader and resampling (`viz/png.py`, `data/image.py`)
against PIL, pixel for pixel: BILINEAR at the loader's ratios and at
non-integer down- and upscales (the fisheye-to-perspective case), NEAREST
on every dtype the loader resizes, the decode of PIL-written 8-bit grey,
RGB, RGBA and 16-bit grey files, one file per scanline filter type, and
the rejection of palette and interlaced files. The port never imports PIL;
these tests use it as the reference."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from panopticnerf_tpu_torch.data.image import load_rgb, resize_bilinear, resize_nearest
from panopticnerf_tpu_torch.viz.png import read_png, write_png


def _image(rng, shape, dtype=np.uint8):
    """Noise over a smooth ramp, so both flat and busy rows occur."""
    hi = 65536 if dtype == np.uint16 else 256
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    ramp = (yy * 5 + xx * 3) % hi
    if len(shape) == 3:
        ramp = np.stack([(ramp * (c + 1)) % hi for c in range(shape[2])], -1)
    noise = rng.integers(0, hi, shape)
    return np.where(rng.uniform(size=shape) < 0.5, ramp, noise).astype(dtype)


# ---------------------------------------------------------------- resampling


@pytest.mark.parametrize("ratio", [0.25, 0.5, 1.0])
@pytest.mark.parametrize("channels", [3, 0])
def test_bilinear_at_ratio_matches_pil(ratio, channels):
    rng = np.random.default_rng(int(ratio * 100) + channels)
    shape = (37, 54, channels) if channels else (37, 54)
    img = _image(rng, shape)
    size = (max(int(54 * ratio), 1), max(int(37 * ratio), 1))   # the loader's size
    want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(img, size), want)


@pytest.mark.parametrize("hw,size", [
    ((40, 40), (32, 24)),     # the fake tree's fisheye resized to its perspective size
    ((1400, 1400), (704, 376)),  # KITTI-360's fisheye at ratio 0.5 to the rectified size
    ((13, 17), (51, 40)),     # upscale, different factors per axis
    ((24, 32), (7, 5)),       # strong non-integer downscale
    ((5, 9), (9, 5)),         # up in one axis, down in the other
])
def test_bilinear_non_integer_matches_pil(hw, size):
    rng = np.random.default_rng(hw[0] * 7 + size[0])
    img = _image(rng, hw + (3,))
    want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(img, size), want)


def _pil_of(arr):
    if arr.dtype == np.int32:
        return Image.frombytes("I", arr.shape[::-1], arr.astype("<i4").tobytes())
    if arr.dtype == np.float32:
        return Image.frombytes("F", arr.shape[::-1], arr.astype("<f4").tobytes())
    return Image.fromarray(arr)   # L (uint8) or I;16 (uint16)


# sizes where PIL's stepped coordinate (modes L, I, F) and its product
# (mode I;16) pick different source pixels, and the loader's own
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.uint8, np.uint16])
@pytest.mark.parametrize("hw,size", [((48, 64), (32, 24)), ((376, 1408), (704, 188)),
                                     ((40, 40), (32, 24)), ((11, 59), (41, 23)),
                                     ((7, 5), (14, 10)), ((24, 32), (32, 24))])
def test_nearest_matches_pil(dtype, hw, size):
    rng = np.random.default_rng(hw[1] + size[0])
    arr = (rng.normal(size=hw) * 100).astype(dtype) if dtype == np.float32 else \
        rng.integers(0, 255 if dtype == np.uint8 else 60000, hw).astype(dtype)
    want = np.asarray(_pil_of(arr).resize(size, Image.NEAREST))
    got = resize_nearest(arr, size)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want.astype(dtype))


# ---------------------------------------------------------------- decoding


@pytest.mark.parametrize("shape,dtype", [((23, 41), np.uint8), ((23, 41, 3), np.uint8),
                                         ((23, 41, 4), np.uint8), ((23, 41), np.uint16)],
                         ids=["grey8", "rgb", "rgba", "grey16"])
def test_decode_pil_written_png(tmp_path, shape, dtype):
    img = _image(np.random.default_rng(len(shape)), shape, dtype)
    path = str(tmp_path / "a.png")
    Image.fromarray(img).save(path)
    want = np.asarray(Image.open(path))
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if dtype == np.uint8:  # the loader's Image.open(...).convert("RGB")
        np.testing.assert_array_equal(load_rgb(path),
                                      np.asarray(Image.open(path).convert("RGB")))


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_filtered(path, img, filters):
    """A PNG whose row y uses scanline filter filters[y % len(filters)]."""
    depth = 16 if img.dtype == np.uint16 else 8
    colour = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1])}[img.ndim]
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    x = raw.reshape(h, w, -1).astype(np.int32)                       # (H, W, bpp)
    left = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], 1)
    up = np.concatenate([np.zeros_like(x[:1]), x[:-1]], 0)
    upleft = np.concatenate([np.zeros_like(up[:, :1]), up[:, :-1]], 1)
    pred = {0: 0 * x, 1: left, 2: up, 3: (left + up) >> 1, 4: _paeth(left, up, upleft)}
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        rows.append(bytes([f]) + ((x[y] - pred[f][y]) & 0xFF).astype(np.uint8).tobytes())
    chunk = lambda tag, data: (struct.pack(">I", len(data)) + tag + data
                               + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("shape,dtype", [((19, 27), np.uint8), ((19, 27, 3), np.uint8),
                                         ((19, 27, 4), np.uint8), ((19, 27), np.uint16)],
                         ids=["grey8", "rgb", "rgba", "grey16"])
def test_decode_each_filter_type(tmp_path, filters, shape, dtype):
    img = _image(np.random.default_rng(sum(filters) + len(shape)), shape, dtype)
    path = str(tmp_path / "f.png")
    _encode_filtered(path, img, filters)
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(want, img)            # the encoder is right
    np.testing.assert_array_equal(read_png(path), want)


def test_rejects_palette_and_interlaced(tmp_path):
    pal = str(tmp_path / "p.png")
    Image.fromarray(np.arange(64, dtype=np.uint8).reshape(8, 8)).convert("P").save(pal)
    with pytest.raises(ValueError, match="p.png: PNG colour type 3"):
        read_png(pal)
    inter = str(tmp_path / "i.png")
    write_png(inter, np.zeros((8, 8), np.uint8))
    data = bytearray(open(inter, "rb").read())
    data[28] = 1                                            # IHDR's interlace byte
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    open(inter, "wb").write(bytes(data))
    assert Image.open(inter).info.get("interlace") == 1     # PIL reads it as Adam7
    with pytest.raises(ValueError, match="i.png: interlaced"):
        read_png(inter)


@pytest.mark.parametrize("arr", [np.arange(60, dtype=np.uint8).reshape(6, 10),
                                 (np.arange(60, dtype=np.uint16) * 999).reshape(6, 10),
                                 np.arange(180, dtype=np.uint8).reshape(6, 10, 3)],
                         ids=["grey8", "grey16", "rgb"])
def test_write_png_round_trips_through_pil_and_read_png(tmp_path, arr):
    path = str(tmp_path / "w.png")
    write_png(path, arr)
    np.testing.assert_array_equal(read_png(path), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
