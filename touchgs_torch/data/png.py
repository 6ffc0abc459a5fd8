"""PNG reading and writing in numpy and ``zlib``, with PIL's semantics.

The port's own module (the JAX package reads every image through PIL): a
scene's images, its uint16-millimetre depth and uncertainty maps and its
masks are PNGs, and PIL is not a dependency of the port.

The reader decodes non-interlaced PNGs of 8-bit gray, gray+alpha, RGB and
RGBA, palette images of 1, 2, 4 or 8 bits, and 16-bit gray (big-endian on
disk), through all five row filters, into the arrays
``np.asarray(PIL.Image.open(path))`` gives.  Anything else in a PNG (another
bit depth, an unknown critical chunk, a bad CRC) raises ``ValueError``.
Files of other formats (JPEG) and Adam7-interlaced PNGs go to PIL, imported
only then; where PIL is absent that raises an ``ImportError`` naming the
file and its format.

The writer emits 8-bit gray, gray+alpha, RGB or RGBA and 16-bit gray with
every row under the Up filter, which this reader undoes with one add a row.

``resize_nearest`` and ``resize_bilinear`` are PIL's ``Image.resize`` with
``NEAREST`` and ``BILINEAR`` on 2-D arrays, sample positions and weights
included; ``resize_lanczos`` is its ``LANCZOS`` on 8-bit images, in PIL's
fixed point and with its premultiplied alpha, byte for byte.
"""
from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → (channels, PIL mode, the bit depths this reader decodes)
_COLOR_TYPES = {
    0: (1, "L", (8, 16)),
    2: (3, "RGB", (8,)),
    3: (1, "P", (1, 2, 4, 8)),
    4: (2, "LA", (8,)),
    6: (4, "RGBA", (8,)),
}


class Decoded(NamedTuple):
    pixels: np.ndarray              # (H, W) or (H, W, C); uint8, or uint16
    mode: str                       # PIL's mode: L, I;16, RGB, P, LA, RGBA
    palette: Optional[np.ndarray]   # (n, 3) uint8 for mode P


def _chunks(data: bytes, path):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: chunk {ctype!r} is truncated or "
                             "fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int,
              path) -> np.ndarray:
    """Undo the row filters of ``raw`` (height rows of a filter byte and
    ``row_bytes`` bytes) → (height, row_bytes) uint8.

    Sub and Up only: per row, Up is one add and Sub a cumulative sum in
    uint8 per byte of the pixel.  With Average or Paeth rows, whose bytes
    each depend on the one ``bpp`` to their left, all rows are decoded
    together along anti-diagonals of (row, pixel): a pixel's left, upper
    and upper-left neighbours all lie on earlier diagonals."""
    raw = raw.reshape(height, row_bytes + 1)
    ftype = raw[:, 0]
    x = raw[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(ftype.max())}")
    out = np.empty((height, row_bytes), np.uint8)
    if not np.isin(ftype, (3, 4)).any():
        prev = np.zeros(row_bytes, np.uint8)
        for r in range(height):
            row = x[r]
            if ftype[r] == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0,
                                dtype=np.uint8).reshape(-1)
            elif ftype[r] == 2:
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    # wavefront: out padded with a zero row on top and a zero pixel on the
    # left, so every neighbour is an index into it
    ncol = row_bytes // bpp
    pad = np.zeros((height + 1, ncol + 1, bpp), np.int16)
    xs = x.reshape(height, ncol, bpp).astype(np.int16)
    f = ftype.astype(np.int16)
    for d in range(height + ncol - 1):
        r = np.arange(max(0, d - ncol + 1), min(height - 1, d) + 1)
        c = d - r
        a = pad[r + 1, c]          # left
        b = pad[r, c + 1]          # up
        ul = pad[r, c]             # upper left
        fr = f[r][:, None]
        pred = np.select(
            [fr == 1, fr == 2, fr == 3, fr == 4],
            [a, b, (a + b) >> 1, _paeth(a, b, ul)], 0)
        pad[r + 1, c + 1] = (xs[r, c] + pred) & 0xFF
    return pad[1:, 1:].reshape(height, row_bytes).astype(np.uint8)


def decode_png(path: str | os.PathLike | bytes) -> Decoded:
    """Decode a non-interlaced PNG, a file or its bytes (see the module
    docstring for what it takes); ``NotImplementedError`` for an
    interlaced one, ``ValueError`` for anything else it does not take."""
    if isinstance(path, bytes):
        data, path = path, "<bytes>"
    else:
        data = Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header = palette = None
    idat = []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype != b"IEND" and ctype[0:1].isupper():
            raise ValueError(f"{path}: unknown critical chunk {ctype!r}")
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, color, comp, filt, interlace = header
    if color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][2]:
        raise ValueError(f"{path}: PNG colour type {color} at bit depth "
                         f"{depth} is not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG compression {comp} or filter "
                         f"method {filt}")
    if interlace == 1:
        raise NotImplementedError(f"{path}: Adam7-interlaced PNG")
    if interlace != 0:
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels, mode, _ = _COLOR_TYPES[color]
    bits = channels * depth
    row_bytes = (width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, want "
                         f"{height * (row_bytes + 1)}")
    rows = _unfilter(raw, height, row_bytes, max(1, bits // 8), path)
    if depth < 8:   # palette indices packed MSB first
        px = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        px = px @ (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        pixels = px[:, :width].astype(np.uint8)
    elif depth == 16:
        pixels = rows.view(">u2").astype(np.uint16).reshape(height, width)
        mode = "I;16"
    else:
        pixels = rows.reshape((height, width, channels) if channels > 1
                              else (height, width))
    return Decoded(pixels, mode, palette if color == 3 else None)


def _pil_open(path, why: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: {why} needs PIL, which is not "
                          "installed") from e
    return Image.open(path)


def _decode_or_pil(path, convert: Optional[str]):
    """``decode_png``, or PIL for a file that is not a PNG or is
    interlaced (then converted to ``convert`` if given)."""
    with open(path, "rb") as f:
        is_png = f.read(len(SIGNATURE)) == SIGNATURE
    try:
        if is_png:
            return decode_png(path)
        why = "an image that is not a PNG"
    except NotImplementedError:
        why = "an Adam7-interlaced PNG"
    im = _pil_open(path, why)
    if convert is not None:
        im = im.convert(convert)
    return Decoded(np.asarray(im), im.mode, None)


def read_png(path: str | os.PathLike) -> np.ndarray:
    """The image's samples as stored: ``np.asarray(Image.open(path))``
    (palette images give their indices)."""
    return _decode_or_pil(path, None).pixels


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB → L: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def read_rgb(path: str | os.PathLike) -> np.ndarray:
    """(H, W, 3) uint8, as ``Image.open(path).convert("RGB")``: gray is
    replicated, alpha dropped without compositing, the palette expanded."""
    px, mode, palette = _decode_or_pil(path, "RGB")
    if mode == "RGB":
        return px
    if mode == "RGBA":
        return np.ascontiguousarray(px[..., :3])
    if mode == "P":
        return palette[np.minimum(px, len(palette) - 1)]
    if mode in ("L", "LA"):
        gray = px if mode == "L" else px[..., 0]
        return np.repeat(gray[..., None], 3, axis=2)
    raise ValueError(f"{path}: mode {mode} has no RGB conversion here")


def read_gray(path: str | os.PathLike) -> np.ndarray:
    """(H, W) uint8, as ``Image.open(path).convert("L")`` of an 8-bit
    image."""
    px, mode, palette = _decode_or_pil(path, "L")
    if mode == "L":
        return px
    if mode == "LA":
        return np.ascontiguousarray(px[..., 0])
    if mode in ("RGB", "RGBA"):
        return _luma(px)
    if mode == "P":
        return _luma(palette)[np.minimum(px, len(palette) - 1)]
    raise ValueError(f"{path}: mode {mode} has no 8-bit gray conversion here")


def image_size(path: str | os.PathLike) -> tuple[int, int]:
    """(height, width), from a PNG's IHDR (PIL's ``Image.open(path).size``
    reversed); another format goes to PIL."""
    with open(path, "rb") as f:
        head = f.read(len(SIGNATURE) + 16)
    if head.startswith(SIGNATURE) and head[12:16] == b"IHDR":
        width, height = struct.unpack(">II", head[16:24])
        return height, width
    with _pil_open(path, "an image that is not a PNG") as im:
        return im.size[1], im.size[0]


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


# channels of an (H, W, C) uint8 array → PNG colour type
_WRITE_COLOR = {2: 4, 3: 2, 4: 6}


def write_png(path: str | os.PathLike, array: np.ndarray) -> None:
    """Write (H, W) uint8 as 8-bit gray, (H, W, 2), (H, W, 3) or (H, W, 4)
    uint8 as gray+alpha, RGB or RGBA, or (H, W) uint16 as 16-bit gray;
    every row under the Up filter."""
    Path(path).write_bytes(encode_png(array, path))


def encode_png(array: np.ndarray, path="<bytes>") -> bytes:
    """``write_png``'s file as bytes (``path`` names it in errors)."""
    a = np.asarray(array)
    if a.dtype == np.uint8 and a.ndim == 2:
        color, depth = 0, 8
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] in _WRITE_COLOR:
        color, depth = _WRITE_COLOR[a.shape[2]], 8
    elif a.dtype == np.uint16 and a.ndim == 2:
        color, depth = 0, 16
        a = a.astype(">u2")
    else:
        raise ValueError(f"{path}: write_png takes (H, W) uint8 or uint16 or "
                         f"(H, W, 2 to 4) uint8, not {a.shape} {a.dtype}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).view(np.uint8).reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]                      # uint8 wraps, as the filter does
    filtered = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index a pixel (``ImagingScaleAffine``): the
    position starts at scale / 2 and steps by the scale, summed in float64
    one step at a time, then truncated."""
    scale = n_in / n_out
    pos = np.add.accumulate(np.r_[0.5 * scale, np.full(n_out - 1, scale)])
    return np.minimum(pos.astype(np.int64), n_in - 1)


def resize_nearest(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(a).resize((width, height), Image.NEAREST)`` for an
    array of shape (H, W) or (H, W, C)."""
    h, w = a.shape[:2]
    if (w, h) == (width, height):
        return a.copy()
    return a[_nearest_index(h, height)][:, _nearest_index(w, width)]


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _lanczos(x: np.ndarray) -> np.ndarray:
    """Resample.c's ``lanczos_filter``: sinc(x)·sinc(x/3) on [-3, 3)."""
    def sinc(t):
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(t == 0.0, 1.0, np.sin(t * np.pi) / (t * np.pi))
    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3), 0.0)


def _bilinear_taps(n_in: int, n_out: int, kernel=_triangle,
                   support: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """(n_out, k) source indices and float64 weights of PIL's resampling
    (``precompute_coeffs`` in ``Resample.c``; BILINEAR by default): the
    kernel of ``support``, stretched by the scale when reducing, normalised
    a row; unused taps carry weight 0."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    reach = support * fscale
    ksize = int(np.ceil(reach)) * 2 + 1
    idx = np.zeros((n_out, ksize), np.int64)
    wgt = np.zeros((n_out, ksize))
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        lo = max(int(center - reach + 0.5), 0)
        hi = min(int(center + reach + 0.5), n_in)
        x = np.arange(lo, hi)
        w = kernel((x - center + 0.5) * (1.0 / fscale))
        total = 0.0
        for v in w:              # summed in order, as Resample.c
            total += v
        if total != 0.0:
            w = w / total
        idx[xx, :hi - lo] = x
        wgt[xx, :hi - lo] = w
    return idx, wgt


def _resample_rows(a: np.ndarray, n_out: int) -> np.ndarray:
    """PIL's horizontal pass: each output column a float64 sum over its
    taps, left to right, stored as float32."""
    idx, wgt = _bilinear_taps(a.shape[1], n_out)
    acc = np.zeros((a.shape[0], n_out))
    for t in range(idx.shape[1]):
        acc += a[:, idx[:, t]].astype(np.float64) * wgt[:, t]
    return acc.astype(np.float32)


def resize_bilinear(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(a).resize((width, height), Image.BILINEAR)`` for a
    float32 (H, W) array (PIL's mode F): the horizontal pass first, then
    the vertical one."""
    a = np.asarray(a, np.float32)
    h, w = a.shape
    if (w, h) == (width, height):
        return a.copy()
    if width != w:
        a = _resample_rows(a, width)
    if height != h:
        a = np.ascontiguousarray(_resample_rows(a.T, height).T)
    return a


PRECISION_BITS = 32 - 8 - 2      # Resample.c's fixed point for 8-bit bands


def _lanczos_pass(a: np.ndarray, n_out: int) -> np.ndarray:
    """PIL's 8-bit horizontal pass over axis 1 of (H, W, C) uint8: each
    weight rounded to PRECISION_BITS (half away from zero), integer sums
    from half a unit, clipped to 0..255."""
    idx, wgt = _bilinear_taps(a.shape[1], n_out, _lanczos, 3.0)
    scaled = wgt * (1 << PRECISION_BITS)
    k = np.trunc(np.where(wgt < 0, scaled - 0.5, scaled + 0.5)).astype(
        np.int64)
    acc = np.full((a.shape[0], n_out, a.shape[2]), 1 << (PRECISION_BITS - 1),
                  np.int64)
    for t in range(idx.shape[1]):
        acc += a[:, idx[:, t]].astype(np.int64) * k[None, :, t, None]
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.uint32) * b + 128
    return ((t >> 8) + t) >> 8


def resize_lanczos(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(a).resize((width, height), Image.LANCZOS)`` for a
    uint8 image of mode L (H, W), LA (H, W, 2), RGB (H, W, 3) or RGBA
    (H, W, 4): the horizontal pass first, then the vertical one; with an
    alpha band, the colour premultiplied by it before (PIL's RGBa, La) and
    divided back after."""
    a = np.asarray(a)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (
            a.ndim == 3 and a.shape[2] not in (2, 3, 4)):
        raise ValueError(f"resize_lanczos takes an 8-bit L, LA, RGB or RGBA "
                         f"array, not {a.shape} {a.dtype}")
    x = a[..., None] if a.ndim == 2 else a
    alpha = x.shape[2] in (2, 4)
    if alpha:
        x = x.copy()
        x[..., :-1] = _muldiv255(x[..., :-1], x[..., -1:].astype(np.uint32))
    h, w = x.shape[:2]
    if width != w:
        x = _lanczos_pass(x, width)
    if height != h:
        x = _lanczos_pass(x.transpose(1, 0, 2), height).transpose(1, 0, 2)
    x = np.ascontiguousarray(x)
    if alpha:
        al = x[..., -1:].astype(np.uint32)
        div = np.minimum(255 * x[..., :-1].astype(np.uint32)
                         // np.maximum(al, 1), 255)
        x[..., :-1] = np.where((al == 0) | (al == 255), x[..., :-1], div)
    return x[..., 0] if a.ndim == 2 else x
