"""The port's PNG codec (``touchgs_torch/data/png.py``) against PIL, which
the JAX package reads every image through: PIL-written files of every mode
and bit depth the reader takes, at odd widths, byte-exact; hand-built
streams of each of the five row filters; the writer's files read back by
PIL; PIL's NEAREST and BILINEAR resizes; the lazy PIL path for JPEG."""
import builtins
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from touchgs_torch.data import png

SIZES = [(7, 13), (33, 65), (50, 1)]
MODES = ["L", "LA", "RGB", "RGBA", "I;16", "P2", "P4", "P16", "P200"]


def _pil_image(mode: str, h: int, w: int, rng) -> Image.Image:
    """A PIL image of ``mode`` (P<n>: a palette of n colours, which PIL
    writes at 1, 2, 4 or 8 bits) with smooth rows, so PIL's encoder picks
    varied filters."""
    if mode == "I;16":
        return Image.fromarray(rng.integers(0, 65536, (h, w)).astype(np.uint16))
    if mode.startswith("P"):
        n = int(mode[1:])
        im = Image.fromarray(rng.integers(0, n, (h, w)).astype(np.uint8), "L"
                             ).convert("P")
        im.putpalette(rng.integers(0, 256, 3 * n).astype(np.uint8).tolist())
        return im
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    a = (np.cumsum(rng.integers(0, 6, (h, w, c)), axis=1) % 256).astype(np.uint8)
    return Image.fromarray(a if c > 1 else a[..., 0], mode)


@pytest.mark.parametrize("mode", MODES)
def test_reader_matches_pil(mode, tmp_path):
    rng = np.random.default_rng(MODES.index(mode))
    for h, w in SIZES:
        path = tmp_path / f"{mode}_{h}x{w}.png"
        _pil_image(mode, h, w, rng).save(path)
        ref = Image.open(path)
        got = png.read_png(path)
        want = np.asarray(ref)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if mode != "I;16":
            np.testing.assert_array_equal(png.read_rgb(path),
                                          np.asarray(ref.convert("RGB")))
            np.testing.assert_array_equal(png.read_gray(path),
                                          np.asarray(ref.convert("L")))


def _encode(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """PNG's forward filter ``ftype`` over (H, row_bytes) uint8 rows."""
    r = rows.astype(np.int16)
    up = np.vstack([np.zeros_like(r[:1]), r[:-1]])
    left = np.hstack([np.zeros_like(r[:, :bpp]), r[:, :-bpp]])
    ul = np.hstack([np.zeros_like(up[:, :bpp]), up[:, :-bpp]])
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
            4: png._paeth(left, up, ul)}[ftype]
    return ((r - pred) & 0xFF).astype(np.uint8)


def _stream(img: np.ndarray, color: int, ftypes) -> bytes:
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    bpp = img.shape[2] if img.ndim == 3 else 1
    enc = {f: _encode(rows, bpp, f) for f in set(ftypes)}
    body = np.hstack([
        np.asarray(ftypes, np.uint8)[:, None],
        np.vstack([enc[f][i] for i, f in enumerate(ftypes)])])
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(body.tobytes()))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_each_row_filter(ftype, tmp_path):
    """Hand-built RGB and gray streams with every row under one filter (or
    the five in turn), decoded exactly; PIL agrees."""
    rng = np.random.default_rng(5)
    for img, color in ((rng.integers(0, 256, (9, 11, 3), dtype=np.uint8), 2),
                       (rng.integers(0, 256, (9, 11), dtype=np.uint8), 0)):
        ftypes = [i % 5 for i in range(9)] if ftype == "mixed" else [ftype] * 9
        path = tmp_path / f"f{ftype}_{color}.png"
        path.write_bytes(_stream(img, color, ftypes))
        np.testing.assert_array_equal(png.read_png(path), img)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_paeth_800x800_matches_pil(tmp_path):
    """A full-width RGB stream with every row under Paeth, the filter whose
    bytes depend on their left neighbour (decoded along anti-diagonals):
    exact, and PIL agrees.  Prints the decode time on this machine."""
    yy, xx = np.mgrid[0:800, 0:800]
    rng = np.random.default_rng(10)
    img = np.clip(np.stack([(xx * 0.7 + yy * 0.3) % 256,
                            (xx * 0.2 + yy * 0.9) % 256,
                            (xx * 0.5 - yy * 0.4 + 400) % 256], -1)
                  + rng.normal(0, 12, (800, 800, 3)), 0, 255).astype(np.uint8)
    path = tmp_path / "paeth.png"
    path.write_bytes(_stream(img, 2, [4] * 800))
    t0 = time.perf_counter()
    got = png.read_rgb(path)
    print(f"all-Paeth 800x800 RGB decode: {time.perf_counter() - t0:.3f} s")
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_writer_read_by_pil(tmp_path):
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 256, (31, 17, 3), dtype=np.uint8),
              rng.integers(0, 256, (31, 17), dtype=np.uint8),
              rng.integers(0, 65536, (31, 17)).astype(np.uint16)]
    for i, a in enumerate(arrays):
        path = tmp_path / f"w{i}.png"
        png.write_png(path, a)
        back = np.asarray(Image.open(path))
        assert back.dtype == a.dtype
        np.testing.assert_array_equal(back, a)
        np.testing.assert_array_equal(png.read_png(path), a)
    with pytest.raises(ValueError, match="write_png takes"):
        png.write_png(tmp_path / "bad.png", np.zeros((4, 4), np.float32))


def test_reader_refuses_what_it_does_not_decode(tmp_path):
    rng = np.random.default_rng(8)
    ihdr = struct.pack(">IIBBBBB", 6, 5, 16, 2, 0, 0, 0)
    path = tmp_path / "rgb16.png"
    path.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                     + png._chunk(b"IDAT", zlib.compress(b"\0" * 5 * 37))
                     + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="colour type 2 at bit depth 16"):
        png.read_png(path)
    good = tmp_path / "good.png"
    png.write_png(good, rng.integers(0, 256, (4, 4), dtype=np.uint8))
    data = bytearray(good.read_bytes())
    data[-20] ^= 0xFF                       # inside the IDAT's payload
    bad = tmp_path / "crc.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(bad)


@pytest.mark.parametrize("shapes", [(48, 64, 30, 40), (48, 64, 100, 129),
                                    (800, 800, 400, 400), (7, 13, 5, 3),
                                    (720, 1280, 48, 64), (5, 3, 7, 13)])
def test_resizes_match_pil(shapes):
    """NEAREST (uint8 masks and float depth) and BILINEAR (float depth)
    at PIL's sample positions and weights, exactly."""
    H, W, h, w = shapes
    rng = np.random.default_rng(H + w)
    f = rng.normal(size=(H, W)).astype(np.float32)
    m = rng.integers(0, 2, (H, W), dtype=np.uint8) * 255
    for a in (f, m):
        np.testing.assert_array_equal(
            png.resize_nearest(a, w, h),
            np.asarray(Image.fromarray(a).resize((w, h), Image.NEAREST)))
    np.testing.assert_array_equal(
        png.resize_bilinear(f, w, h),
        np.asarray(Image.fromarray(f).resize((w, h), Image.BILINEAR)))


def test_jpeg_goes_to_pil_and_raises_without_it(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    path = tmp_path / "img.jpg"
    Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)).save(
        path, quality=95)
    np.testing.assert_array_equal(png.read_rgb(path),
                                  np.asarray(Image.open(path).convert("RGB")))
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match=r"img\.jpg: an image that is not a "
                                          "PNG needs PIL"):
        png.read_rgb(path)
    # a 1x1 Adam7 stream: pass 1 holds the one pixel, the other passes none
    inter = tmp_path / "adam7.png"
    ihdr = struct.pack(">IIBBBBB", 1, 1, 8, 0, 0, 0, 1)
    inter.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                      + png._chunk(b"IDAT", zlib.compress(b"\x00\x7f"))
                      + png._chunk(b"IEND", b""))
    with pytest.raises(ImportError, match="Adam7-interlaced PNG needs PIL"):
        png.read_png(inter)
    monkeypatch.undo()
    np.testing.assert_array_equal(png.read_png(inter), [[127]])
