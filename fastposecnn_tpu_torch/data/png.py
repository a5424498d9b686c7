"""PNG reading and writing with the standard library's `zlib` and no image
package (the counterpart of what the JAX package does with PIL or libpng in
`data/nocs.py`, `data/nocs_writer.py` and `data/native_loader.py`).

A PNG is a list of CRC-checked chunks; its pixel rows are deflated with
zlib, each row behind one filter byte (PNG spec, section 9). `decode_png`
parses the chunks, inflates the IDAT stream with `zlib` and undoes the
filters 0-4. The unfilter is sequential along a row (Paeth's and the
Average filter depend on the byte just reconstructed), so it has two
versions: the native one (`fpcnn_png_unfilter` in `native/augment.cpp`,
built with g++ at first use; the default) and the numpy one (the plain
version, a Python loop over a row's pixels for those two filters). The path
is the caller's `native` argument; a failed build raises.

Read: gray at 8 and 16 bits, RGB and RGBA at 8 bits, palette at 8 bits,
not interlaced; anything else raises and names the file. 16-bit samples are
big-endian in the file and come out as native uint16. The arrays are what
`np.asarray(PIL.Image.open(path))` gives: [H, W] for gray and palette (the
palette indices), [H, W, C] otherwise. `rgb=True` gives [H, W, 3] uint8 as
PIL's `convert("RGB")` and the JAX package's native reader do (gray
repeated, alpha dropped, palette looked up).

Written (`encode_png`): uint8 [H, W], [H, W, 3] or [H, W, 4], or uint16
[H, W]; every row with filter 0, deflated at `compress_level` (1, the
speed the JAX writer uses for its throwaway banks).
"""

from __future__ import annotations

import ctypes
import pathlib
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (color type, bit depth) -> channels
READ_FORMATS = {(0, 8): 1, (0, 16): 1, (2, 8): 3, (3, 8): 1, (6, 8): 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> color type, for writing


def _chunks(data: bytes, path):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        end = pos + 12 + n
        if end > len(data):
            break
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: bad CRC in a {kind.decode(errors='replace')} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def unfilter_numpy(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo filters 0-4 of `height` rows of (1 + row_bytes) bytes; bpp is
    the bytes of one pixel. Returns [height, row_bytes] uint8."""
    rows = raw.reshape(height, row_bytes + 1)
    out = np.empty((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    zero = np.zeros(bpp, np.int16)
    for r in range(height):
        kind, x = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = x.copy()
        elif kind == 1:  # Sub: a running sum mod 256 over each byte lane
            cur = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = x + prev
        elif kind in (3, 4):  # Average, Paeth: each pixel needs the one before
            cur = np.empty(row_bytes, np.uint8)
            xs, up = x.astype(np.int16), prev.astype(np.int16)
            a, c = zero, zero
            for i in range(0, row_bytes, bpp):
                b = up[i:i + bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                a = (xs[i:i + bpp] + pred) & 0xFF
                cur[i:i + bpp] = a
                c = b
        else:
            raise ValueError(f"row {r}: filter type {kind} is not 0-4")
        out[r] = cur
        prev = cur
    return out


def unfilter_native(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """`unfilter_numpy` through `fpcnn_png_unfilter` (g++, `native/augment.cpp`)."""
    from fastposecnn_tpu_torch.native import augment_lib

    lib = augment_lib.load_library()
    src = np.ascontiguousarray(raw, np.uint8)
    if src.size != height * (row_bytes + 1):
        raise ValueError(f"{src.size} bytes for {height} rows of {row_bytes + 1}")
    out = np.empty((height, row_bytes), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    bad = lib.fpcnn_png_unfilter(src.ctypes.data_as(u8), out.ctypes.data_as(u8),
                                 height, row_bytes, bpp)
    if bad:
        raise ValueError(f"row {bad - 1}: filter type {int(src[(bad - 1) * (row_bytes + 1)])} "
                         "is not 0-4")
    return out


def decode_png(path, native: bool = True, rgb: bool = False) -> np.ndarray:
    """The pixels of the PNG file `path` (see the module docstring)."""
    data = pathlib.Path(path).read_bytes()
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG (Adam7) is not supported")
    channels = READ_FORMATS.get((color, depth))
    if channels is None:
        raise ValueError(f"{path}: PNG color type {color} at {depth} bits is not supported "
                         "(gray 8/16, RGB 8, RGBA 8, palette 8)")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel rows, expected {h * (w * bpp + 1)}")
    rows = (unfilter_native if native else unfilter_numpy)(raw, h, w * bpp, bpp)
    if depth == 16:
        arr = rows.view(">u2").astype(np.uint16).reshape(h, w)
    else:
        arr = rows.reshape((h, w) if channels == 1 else (h, w, channels))
    if not rgb:
        return arr
    if color == 3:
        return palette[arr]
    if depth != 8:
        raise ValueError(f"{path}: a 16-bit PNG has no 8-bit RGB form")
    return np.repeat(arr[..., None], 3, axis=-1) if arr.ndim == 2 else arr[..., :3].copy()


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(path, arr: np.ndarray, compress_level: int = 1) -> None:
    """Write uint8 gray/RGB/RGBA or uint16 gray `arr` as a PNG at `path`."""
    arr = np.asarray(arr)
    channels = 1 if arr.ndim == 2 else (arr.shape[2] if arr.ndim == 3 else 0)
    if arr.dtype == np.uint8 and channels in _COLOR_TYPE:
        depth, rows = 8, arr
    elif arr.dtype == np.uint16 and arr.ndim == 2:
        depth, rows = 16, arr.astype(">u2")
    else:
        raise ValueError(f"cannot write a {arr.dtype} array of shape {arr.shape} as PNG "
                         "(uint8 [H, W], [H, W, 3], [H, W, 4] or uint16 [H, W])")
    h, w = arr.shape[:2]
    body = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), body], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[channels], 0, 0, 0)
    data = (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), compress_level))
            + _chunk(b"IEND", b""))
    pathlib.Path(path).write_bytes(data)
