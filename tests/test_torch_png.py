"""Port parity for the PNG codec (`fastposecnn_tpu_torch/data/png.py` and
the native unfilter `fpcnn_png_unfilter` in `native/augment.cpp`), held
against PIL and the JAX package's libpng writer; the counterparts of
`tests/test_native.py:16-44, 148-165`.

Decoded pixels are bit-equal to what `np.asarray(PIL.Image.open(path))`
gives (and `convert("RGB")` for `rgb=True`) on files that PIL writes with
its adaptive filters, on files written here with each of the five filters
forced, and on the JAX writer's files; the native unfilter equals the numpy
one on random filtered streams. Tolerance: exact.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from fastposecnn_tpu.data import native_loader as jnl
from fastposecnn_tpu_torch.data import png

PATHS = ["native", "numpy"]


def filter_types(path) -> set:
    """The filter byte of every row of a (non-interlaced) PNG file."""
    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", payload[:10])
        elif kind == b"IDAT":
            idat += payload
        pos += 12 + n
    bpp = png.READ_FORMATS[(color, depth)] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[r * (w * bpp + 1)] for r in range(h)}


def forward_filter(rows: np.ndarray, kinds, bpp: int) -> bytes:
    """Filter [h, row_bytes] uint8 rows with the given filter type per row
    (PNG spec, section 9): the encoder side of what the decoder undoes."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for row, kind in zip(rows.astype(np.int64), kinds):
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([kind]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def write_filtered(path, arr: np.ndarray, kinds, interlace: int = 0) -> None:
    """A PNG of uint8 gray/RGB/RGBA or uint16 gray `arr` whose rows carry the
    filter types `kinds` (the header's interlace method `interlace`)."""
    color = {1: 0, 3: 2, 4: 6}[1 if arr.ndim == 2 else arr.shape[2]]
    depth = 16 if arr.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr)
    rows = rows.view(np.uint8).reshape(arr.shape[0], -1)
    bpp = (1 if arr.ndim == 2 else arr.shape[2]) * depth // 8
    ihdr = struct.pack(">IIBBBBB", arr.shape[1], arr.shape[0], depth, color, 0, 0, interlace)
    body = zlib.compress(forward_filter(rows, kinds, bpp), 6)
    chunk = lambda k, p: (struct.pack(">I", len(p)) + k + p  # noqa: E731
                          + struct.pack(">I", zlib.crc32(k + p)))
    open(path, "wb").write(png.SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", body)
                           + chunk(b"IEND", b""))


def images(rng):
    """Images on which PIL's adaptive filter picks several filter types:
    noise, gradients and smooth rows."""
    yy, xx = np.mgrid[:36, :40]
    smooth = ((xx * 3 + yy * 2) % 256).astype(np.uint8)
    rgb = np.concatenate([rng.integers(0, 256, (12, 40, 3)),
                          np.repeat(smooth[:12, :, None], 3, -1),
                          np.stack([smooth[:12], smooth[12:24], smooth[24:]], -1)]
                         ).astype(np.uint8)
    return {
        "rgb": rgb,
        "rgba": np.dstack([rgb, smooth]),
        "gray": np.concatenate([smooth[:18], rng.integers(0, 256, (18, 40))]).astype(np.uint8),
        "gray16": np.concatenate([(xx[:18] * 1500 + yy[:18] * 7),
                                  rng.integers(0, 65536, (18, 40))]).astype(np.uint16),
    }


@pytest.mark.parametrize("path", PATHS)
def test_decodes_pil_files_bit_equal(tmp_path, path):
    """PIL's own files (adaptive filters) of every read format, the palette
    included: the samples and the RGB form equal PIL's."""
    rng = np.random.default_rng(0)
    seen = set()
    for name, arr in images(rng).items():
        f = tmp_path / f"{name}.png"
        Image.fromarray(arr).save(f)
        seen |= filter_types(f)
        want = np.asarray(Image.open(f))
        got = png.decode_png(f, native=path == "native")
        assert got.dtype == want.dtype and np.array_equal(got, want), name
        if arr.dtype == np.uint8:
            rgb = png.decode_png(f, native=path == "native", rgb=True)
            np.testing.assert_array_equal(rgb, np.asarray(Image.open(f).convert("RGB")))
    assert seen >= {0, 1, 2, 4}  # PIL's adaptive choice never took Average here
    pal = tmp_path / "palette.png"
    Image.fromarray(images(rng)["rgb"]).convert("P").save(pal)
    np.testing.assert_array_equal(png.decode_png(pal, native=path == "native"),
                                  np.asarray(Image.open(pal)))
    np.testing.assert_array_equal(png.decode_png(pal, native=path == "native", rgb=True),
                                  np.asarray(Image.open(pal).convert("RGB")))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("fmt", ["rgb", "rgba", "gray", "gray16"])
def test_all_five_filters_bit_equal_to_pil(tmp_path, fmt, path):
    """Every filter type, forced row by row (each type on several rows, the
    first row included), decodes as PIL decodes the same file."""
    arr = images(np.random.default_rng(1))[fmt]
    kinds = [r % 5 for r in range(arr.shape[0])]
    f = tmp_path / "f.png"
    write_filtered(f, arr, kinds)
    assert filter_types(f) == {0, 1, 2, 3, 4}
    want = np.asarray(Image.open(f))
    np.testing.assert_array_equal(want, arr)
    got = png.decode_png(f, native=path == "native")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,shape,dtype", [("rgb", (24, 36, 3), np.uint8),
                                              ("gray", (24, 36), np.uint8),
                                              ("d16", (24, 36), np.uint16),
                                              ("rgba", (7, 5, 4), np.uint8)])
def test_encode_round_trips_through_pil_and_back(tmp_path, name, shape, dtype):
    """`encode_png` writes what PIL reads back exactly, as the JAX package's
    libpng encoder does (`tests/test_native.py:148-161`), and what both
    unfilters decode exactly."""
    rng = np.random.default_rng(2)
    arr = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    f = tmp_path / f"{name}.png"
    png.encode_png(f, arr)
    back = np.asarray(Image.open(f))
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    assert filter_types(f) == {0}
    for native in (True, False):
        np.testing.assert_array_equal(png.decode_png(f, native=native), arr)


def test_decodes_the_jax_writers_files(tmp_path):
    """The JAX package's libpng encoder at level 1 (its bank writer's call)
    and PIL's writer at level 1 (its fallback): decoded bit-equal to PIL."""
    if not jnl.available():
        pytest.skip("the JAX package's native library is not built")
    rng = np.random.default_rng(3)
    for name, arr in images(rng).items():
        if arr.ndim == 3 and arr.shape[2] == 4:
            continue  # the bank writer writes no RGBA
        for writer in ("libpng", "pil"):
            f = tmp_path / f"{name}_{writer}.png"
            if writer == "libpng":
                jnl.encode_png(f, arr, compress_level=1)
            else:
                Image.fromarray(arr).save(f, compress_level=1)
            want = np.asarray(Image.open(f))
            for native in (True, False):
                got = png.decode_png(f, native=native)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {writer}")
            np.testing.assert_array_equal(jnl.decode_png(f).squeeze(), want)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_equals_numpy(bpp):
    """Random filtered streams (every filter type, random bytes) through both
    unfilters: equal byte for byte."""
    rng = np.random.default_rng(bpp)
    h, row_bytes = 40, bpp * 23
    raw = rng.integers(0, 256, (h, row_bytes + 1)).astype(np.uint8)
    raw[:, 0] = rng.integers(0, 5, h)
    raw[0, 0] = 4  # Paeth on the first row: b and c are 0
    raw = raw.reshape(-1)
    np.testing.assert_array_equal(png.unfilter_native(raw, h, row_bytes, bpp),
                                  png.unfilter_numpy(raw, h, row_bytes, bpp))


@pytest.mark.parametrize("native", [True, False], ids=PATHS)
def test_bad_filter_type_raises(native):
    raw = np.zeros((3, 9), np.uint8)
    raw[1, 0] = 7
    with pytest.raises(ValueError, match="row 1: filter type 7"):
        (png.unfilter_native if native else png.unfilter_numpy)(raw.reshape(-1), 3, 8, 1)


def test_missing_interlaced_unsupported_and_bad_dtype_raise(tmp_path):
    with pytest.raises(OSError):
        png.decode_png(tmp_path / "nope.png")
    img = np.random.default_rng(4).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    inter = tmp_path / "interlaced.png"
    write_filtered(inter, img, [0] * 16, interlace=1)  # PIL writes no Adam7 file
    with pytest.raises(ValueError, match="interlaced.png: interlaced"):
        png.decode_png(inter)
    ga = tmp_path / "gray_alpha.png"
    Image.fromarray(img[..., :2]).save(ga)  # color type 4
    with pytest.raises(ValueError, match="gray_alpha.png: PNG color type 4"):
        png.decode_png(ga)
    (tmp_path / "junk.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(tmp_path / "junk.png")
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 2), np.uint8),
                np.zeros((4, 4, 3), np.uint16)):
        with pytest.raises(ValueError):
            png.encode_png(tmp_path / "x.png", bad)


def test_bad_crc_raises(tmp_path):
    f = tmp_path / "c.png"
    png.encode_png(f, np.zeros((4, 4), np.uint8))
    data = bytearray(f.read_bytes())
    data[-20] ^= 0xFF  # inside the IDAT payload
    f.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad CRC"):
        png.decode_png(f)
