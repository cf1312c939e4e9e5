"""The port's image I/O (rvdd_tpu_torch/data/io.py: TIFF and PNG in numpy
and the standard library) against rvdd_tpu's (imageio): files written by
either package read back bit for bit in the other, and the flavours the
port does not read raise."""

import struct
import zlib

import numpy as np
import pytest

from rvdd_tpu.data import io as jio
from rvdd_tpu_torch.data import io


def _arr(rng, shape, dtype):
    if dtype == np.uint16:
        return rng.integers(0, 4096, shape).astype(np.uint16)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return (rng.standard_normal(shape) * 1000).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_tiff_round_trips_both_ways(tmp_path, dtype, c):
    """[H, W, C] float32 or uint16: the port reads rvdd_tpu's file and
    rvdd_tpu reads the port's, bit-exact (2 channels are the flow cache's;
    imageio stores them as H pages of [W, 2])."""
    a = _arr(np.random.default_rng(c), (23, 37, c), dtype)
    jio.imwrite(str(tmp_path / "j.tif"), a if c > 1 else a[..., 0])
    got = io.imread(str(tmp_path / "j.tif"))
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got, a)
    io.imwrite(str(tmp_path / "t.tiff"), a)
    back = jio.imread(str(tmp_path / "t.tiff"))
    assert back.dtype == a.dtype and back.shape == a.shape
    np.testing.assert_array_equal(back, a)


def _tiff(a: np.ndarray, bo: str, rows: int) -> bytes:
    """A classic TIFF of [H, W, C] in byte order ``bo``, ``rows`` rows a
    strip: header, image data, tag arrays, then the IFD."""
    h, w, c = a.shape
    data = a.astype(a.dtype.newbyteorder(bo)).tobytes()
    row = w * c * a.dtype.itemsize
    starts = list(range(0, h, rows))
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [a.dtype.itemsize * 8] * c), (259, 3, [1]),
            (262, 3, [1]), (273, 4, [8 + y * row for y in starts]), (277, 3, [c]),
            (278, 4, [rows]), (279, 4, [min(rows, h - y) * row for y in starts]),
            (339, 3, [3 if a.dtype.kind == "f" else 1] * c)]
    extra, entries = b"", b""
    for tag, typ, vals in tags:
        packed = struct.pack(bo + ("H" if typ == 3 else "I") * len(vals), *vals)
        if len(packed) > 4:
            at, extra = 8 + len(data) + len(extra), extra + packed
            packed = struct.pack(bo + "I", at)
        entries += struct.pack(bo + "HHI", tag, typ, len(vals)) + packed.ljust(4, b"\0")
    ifd = 8 + len(data) + len(extra)
    return ((b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42, ifd) + data + extra
            + struct.pack(bo + "H", len(tags)) + entries + struct.pack(bo + "I", 0))


@pytest.mark.parametrize("bo", ["<", ">"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_tiff_strips_and_byte_orders(tmp_path, bo, dtype):
    """Several strips, either byte order: the port reads what imageio
    reads."""
    a = _arr(np.random.default_rng(7), (19, 13, 3), dtype)
    p = tmp_path / "s.tif"
    p.write_bytes(_tiff(a, bo, rows=4))
    np.testing.assert_array_equal(io.imread(str(p)), a)
    np.testing.assert_array_equal(jio.imread(str(p)), a)


def test_tiff_other_flavours_raise(tmp_path):
    """A compressed TIFF raises, and so does a BigTIFF header."""
    from PIL import Image

    a = _arr(np.random.default_rng(1), (16, 20), np.uint16)
    p = str(tmp_path / "lzw.tif")
    Image.fromarray(a).save(p, compression="tiff_lzw")
    np.testing.assert_array_equal(jio.imread(p)[..., 0], a)  # a valid file
    with pytest.raises(ValueError, match="compressed"):
        io.imread(p)
    (tmp_path / "big.tif").write_bytes(b"II" + struct.pack("<HHHQ", 43, 8, 0, 16))
    with pytest.raises(ValueError):
        io.imread(str(tmp_path / "big.tif"))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_round_trips_both_ways(tmp_path, c):
    """8-bit greyscale, RGB and RGBA, noise and a smooth image (imageio's
    writer picks the Sub, Up and Paeth filters for it)."""
    rng = np.random.default_rng(c)
    yy, xx = np.mgrid[0:29, 0:41]
    smooth = ((np.sin(xx / 5) * np.cos(yy / 7) + 1) * 120)[..., None] + np.arange(c)
    for a in (_arr(rng, (29, 41, c), np.uint8), smooth.astype(np.uint8)):
        jio.imwrite(str(tmp_path / "j.png"), a if c > 1 else a[..., 0])
        np.testing.assert_array_equal(io.imread(str(tmp_path / "j.png")), a)
        io.imwrite(str(tmp_path / "t.png"), a)
        np.testing.assert_array_equal(jio.imread(str(tmp_path / "t.png")), a)


def _png(rows: np.ndarray, ftypes, c: int, depth=8, interlace=0) -> bytes:
    """A PNG whose rows are given already filtered, with their filter bytes."""
    h = rows.shape[0]
    w = rows.shape[1] // c

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    raw = b"".join(bytes([f]) + r.tobytes() for f, r in zip(ftypes, rows))
    ctype = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                             interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_every_filter(tmp_path):
    """All five row filters, Average (3) included, which imageio's writer
    does not pick: the port decodes them as imageio does."""
    rng = np.random.default_rng(3)
    h, w, c = 10, 9, 3
    img = rng.integers(0, 256, (h, w * c)).astype(np.int64)
    ftypes = [0, 1, 2, 3, 4, 3, 4, 1, 2, 3]
    rows = np.zeros_like(img)
    for y, f in enumerate(ftypes):
        prev = img[y - 1] if y else np.zeros(w * c, np.int64)
        for i in range(w * c):
            a = img[y, i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else cc
            rows[y, i] = (img[y, i] - pred) % 256
    p = tmp_path / "f.png"
    p.write_bytes(_png(rows.astype(np.uint8), ftypes, c))
    want = img.astype(np.uint8).reshape(h, w, c)
    np.testing.assert_array_equal(jio.imread(str(p)), want)
    np.testing.assert_array_equal(io.imread(str(p)), want)


def test_png_other_flavours_raise(tmp_path):
    rows = np.zeros((4, 12), np.uint8)
    for name, kw in (("d16.png", dict(depth=16)), ("il.png", dict(interlace=1))):
        (tmp_path / name).write_bytes(_png(rows, [0] * 4, 3, **kw))
        with pytest.raises(ValueError):
            io.imread(str(tmp_path / name))
    with pytest.raises(ValueError):
        io.imread(str(tmp_path / "x.jpg"))
