"""PNG reading and writing with the standard library's ``zlib`` and numpy.

The port decodes every PNG with :func:`read_png`, also where PIL is
installed, so that the card's host and the CPU read the same bytes the same
way. It reads 8-bit greyscale, greyscale + alpha, RGB and RGBA images,
non-interlaced, with any of the five row filters; interlaced, palette and
16-bit (or 1-, 2- and 4-bit) files raise. :func:`read_rgb` converts what it
reads to RGB as PIL's ``convert("RGB")`` does (grey replicated, alpha
dropped) and hands any other format (JPEG, TIFF) to PIL, imported when
needed.

Row filters (PNG specification §9): None and Up are vector operations on a
row, Sub a running sum along it. Average and Paeth depend on the decoded
pixel to the left, so an image that uses them is decoded along
anti-diagonals: pixel (r, j) needs (r, j-1), (r-1, j) and (r-1, j-1), which
all lie on earlier diagonals, so each diagonal is one vector step.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (PNG specification §11.2.2); 3 (palette) is refused
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield tag, body
        pos += 12 + length
        if tag == b"IEND":
            return
    raise ValueError("PNG file without an IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, channels] (1 grey, 2 grey + alpha, 3 RGB,
    4 RGBA)."""
    header, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour == 3:
        raise ValueError("palette PNG files are not supported (convert to RGB)")
    if colour not in CHANNELS:
        raise ValueError(f"unknown PNG colour type {colour}")
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG files are not supported (8-bit only)")
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    bpp = CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (1 + w * bpp)}")
    rows = raw.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    filtered = rows[:, 1:].reshape(h, w, bpp)
    if (ftype >= 3).any():
        return _unfilter_diagonals(filtered, ftype)
    return _unfilter_rows(filtered, ftype)


def _unfilter_rows(filtered: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """None, Sub and Up only: row by row, each row one vector operation."""
    out = np.empty_like(filtered)
    prior = np.zeros_like(filtered[0])
    for r, f in enumerate(ftype):
        row = filtered[r]
        if f == 1:
            row = np.cumsum(row, axis=0, dtype=np.uint8)  # wraps mod 256
        elif f == 2:
            row = row + prior
        out[r] = row
        prior = out[r]
    return out


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonals(filtered: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Any filters: one vector step per anti-diagonal r + j = d, on an
    int32 copy with a zero row above and a zero column to the left (the
    specification's bytes outside the image)."""
    h, w, bpp = filtered.shape
    x = np.zeros((h + 1, w + 1, bpp), np.int32)
    src = filtered.astype(np.int32)
    ft = ftype.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        j = d - r
        a = x[r + 1, j]  # left
        b = x[r, j + 1]  # up
        c = x[r, j]  # up-left
        f = ft[r][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, 0))
        pred = np.where(f == 3, (a + b) >> 1, pred)
        pred = np.where(f == 4, _paeth(a, b, c), pred)
        x[r + 1, j + 1] = (src[r, j] + pred) & 0xFF
    return x[1:, 1:].astype(np.uint8)


def read_png(path: Union[str, Path]) -> np.ndarray:
    """uint8 [H, W, channels] of an 8-bit PNG file (see :func:`decode_png`)."""
    return decode_png(Path(path).read_bytes())


def to_rgb(img: np.ndarray) -> np.ndarray:
    """[H, W, 1|2|3|4] uint8 -> [H, W, 3], as PIL's ``convert("RGB")``:
    grey is replicated, alpha is dropped."""
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    if c in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    if c in (3, 4):
        return np.ascontiguousarray(img[:, :, :3])
    raise ValueError(f"no RGB conversion for {c} channels")


def read_rgb(path: Union[str, Path]) -> np.ndarray:
    """uint8 [H, W, 3] of an image file: PNG through :func:`read_png`, any
    other format through PIL (raises when PIL is not installed)."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        return to_rgb(read_png(path))
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {path.suffix or 'this'} files ({path.name}) needs PIL (Pillow), "
            "which is not installed; only PNG is read without it") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _filter_rows(img: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """The filtered bytes of uint8 [H, W, bpp] with row filters ``ftype``
    [H]: each filter predicts from the unfiltered image, so every row is a
    vector operation."""
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    f = ftype.astype(np.int32)[:, None, None]
    pred = np.where(f == 1, a, np.where(f == 2, b, 0))
    pred = np.where(f == 3, (a + b) >> 1, pred)
    pred = np.where(f == 4, _paeth(a, b, c), pred)
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, filters: Union[int, Sequence[int]] = 0,
               level: int = 6) -> bytes:
    """uint8 [H, W] or [H, W, 1|2|3|4] -> PNG bytes. ``filters``: one row
    filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) for every row, or a
    sequence cycled over the rows."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, bpp = img.shape
    colour = {c: t for t, c in CHANNELS.items()}.get(bpp)
    if colour is None:
        raise ValueError(f"no PNG colour type for {bpp} channels")
    seq = [filters] if isinstance(filters, int) else list(filters)
    if not seq or any(not 0 <= f <= 4 for f in seq):
        raise ValueError(f"row filters are 0..4, got {filters}")
    ftype = np.resize(np.asarray(seq, np.uint8), h)
    rows = np.concatenate([ftype[:, None], _filter_rows(img, ftype).reshape(h, w * bpp)],
                          axis=1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: Union[str, Path], img: np.ndarray,
              filters: Optional[Union[int, Sequence[int]]] = 0) -> None:
    """Write uint8 [H, W] or [H, W, 1|2|3|4] as an 8-bit PNG file."""
    Path(path).write_bytes(encode_png(img, 0 if filters is None else filters))
