"""Image I/O in numpy and the standard library (port of rvdd_tpu/data/io.py,
which reads and writes through imageio): the dataset formats, read and
written bit for bit as imageio reads and writes them.

* TIFF: classic (not BigTIFF), uncompressed, chunky, in strips, either byte
  order; samples float32, uint16 or uint8, 1-4 a pixel.  A file of several
  pages reads as the pages stacked on a new first axis, as imageio reads
  it (imageio's Pillow writer stores a 2-channel array [H, W, 2] as H pages
  of [W, 2]).  The writer stores one page, little-endian, one strip.  Any
  other flavour (compression, planar or tiled layout, a predictor) raises.
* PNG: 8-bit greyscale, RGB or RGBA, non-interlaced, any of the five row
  filters; the writer uses filter 0.  Other PNGs raise.

``imread`` returns [H, W, C] (a channel axis added to a single-channel
image).  The native decode pool of rvdd_tpu (data/native.py) is not ported.
"""

from __future__ import annotations

import fnmatch
import os
import struct
import zlib
from typing import List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

_TIFF_TYPES = {3: ("H", 2), 4: ("I", 4)}  # SHORT, LONG
_TIFF_SAMPLES = {(3, 32): np.float32, (1, 16): np.uint16, (1, 8): np.uint8}


def _tiff_entries(d: bytes, bo: str, off: int):
    """The entries of the IFD at ``off`` as {tag: [values]} and the next
    IFD's offset."""
    if off + 2 > len(d):
        raise ValueError("TIFF: IFD offset beyond the file")
    (n,) = struct.unpack_from(bo + "H", d, off)
    tags = {}
    for k in range(n):
        tag, typ, count, _ = struct.unpack_from(bo + "HHII", d, off + 2 + 12 * k)
        if typ not in _TIFF_TYPES:
            continue  # ASCII, RATIONAL, ...: descriptive tags the decoder ignores
        fmt, size = _TIFF_TYPES[typ]
        at = off + 2 + 12 * k + 8
        if count * size > 4:
            (at,) = struct.unpack_from(bo + "I", d, at)
        tags[tag] = list(struct.unpack_from(bo + fmt * count, d, at))
    (nxt,) = struct.unpack_from(bo + "I", d, off + 2 + 12 * n)
    return tags, nxt


def _tiff_page(d: bytes, bo: str, tags: dict) -> np.ndarray:
    def one(tag, default=None):
        v = tags.get(tag)
        if v is None:
            if default is None:
                raise ValueError(f"TIFF: tag {tag} missing")
            return default
        if len(set(v)) != 1:
            raise ValueError(f"TIFF: tag {tag} differs by sample: {v}")
        return v[0]

    if one(259, 1) != 1:
        raise ValueError("TIFF: compressed files are not supported")
    if one(284, 1) != 1:
        raise ValueError("TIFF: planar layout is not supported")
    if 322 in tags or 324 in tags:
        raise ValueError("TIFF: tiled files are not supported")
    if one(317, 1) != 1:
        raise ValueError("TIFF: predictors are not supported")
    w, h, c = one(256), one(257), one(277, 1)
    key = (one(339, 1), one(258, 1))
    if key not in _TIFF_SAMPLES or not 1 <= c <= 4:
        raise ValueError(f"TIFF: unsupported samples (format, bits) {key} x {c}")
    dt = np.dtype(_TIFF_SAMPLES[key]).newbyteorder(bo)
    offsets, counts = tags.get(273, []), tags.get(279, [])
    if not offsets or len(offsets) != len(counts):
        raise ValueError("TIFF: bad strip tables")
    need = h * w * c * dt.itemsize
    if len(offsets) == 1 or all(o + n == o2 for o, n, o2 in zip(offsets, counts, offsets[1:])):
        data = d[offsets[0]:offsets[0] + sum(counts)]  # contiguous strips: no copy
    else:
        data = b"".join(d[o:o + n] for o, n in zip(offsets, counts))
    if len(data) < need:
        raise ValueError(f"TIFF: strips hold {len(data)} bytes, the image needs {need}")
    a = np.frombuffer(data[:need], dt).astype(dt.newbyteorder("="), copy=False)
    return a.reshape(h, w, c) if c > 1 else a.reshape(h, w)


def read_tiff(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        d = memoryview(bytearray(f.read()))  # writable: the arrays are views of it
    bo = {b"II": "<", b"MM": ">"}.get(bytes(d[:2]))
    if bo is None or len(d) < 8:
        raise ValueError(f"{path}: not a TIFF file")
    magic, off = struct.unpack_from(bo + "HI", d, 2)
    if magic != 42:
        raise ValueError(f"{path}: not a classic TIFF (magic {magic})")
    pages, seen = [], set()
    while off:
        if off in seen:
            raise ValueError(f"{path}: IFD loop")
        seen.add(off)
        tags, off = _tiff_entries(d, bo, off)
        pages.append(_tiff_page(d, bo, tags))
    if not pages:
        raise ValueError(f"{path}: no image")
    return pages[0] if len(pages) == 1 else np.stack(pages)


def write_tiff(path: str, arr: np.ndarray) -> None:
    """One page, little-endian, one strip; [H, W] or [H, W, C<=4] of
    float32, uint16 or uint8."""
    a = np.ascontiguousarray(arr)
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or not 1 <= a.shape[2] <= 4:
        raise ValueError(f"TIFF: want [H, W] or [H, W, C<=4], got {a.shape}")
    fmt = {np.dtype(np.float32): 3, np.dtype(np.uint16): 1, np.dtype(np.uint8): 1}.get(a.dtype)
    if fmt is None:
        raise TypeError(f"TIFF: unsupported dtype {a.dtype}")
    h, w, c = a.shape
    data = memoryview(np.ascontiguousarray(a, a.dtype.newbyteorder("<"))).cast("B")
    extra = bytearray()
    base = 8 + len(data)

    def value(typ, vals):
        f, size = _TIFF_TYPES[typ]
        packed = struct.pack("<" + f * len(vals), *vals)
        if len(packed) <= 4:
            return packed.ljust(4, b"\0")
        at = base + len(extra)
        extra.extend(packed + b"\0" * (len(packed) % 2))
        return struct.pack("<I", at)

    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [a.dtype.itemsize * 8] * c),
            (259, 3, [1]), (262, 3, [2 if c >= 3 else 1]), (273, 4, [8]), (277, 3, [c]),
            (278, 4, [h]), (279, 4, [len(data)]), (284, 3, [1])]
    if c in (2, 4):
        tags.append((338, 3, [2 if c == 4 else 0]))  # the extra sample: alpha, or unspecified
    tags.append((339, 3, [fmt] * c))
    entries = b"".join(struct.pack("<HHI", t, typ, len(v)) + value(typ, v) for t, typ, v in tags)
    if (base + len(extra)) % 2:
        extra.extend(b"\0")
    ifd = struct.pack("<H", len(tags)) + entries + struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, base + len(extra)))
        f.write(data)
        f.write(bytes(extra) + ifd)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # greyscale, RGB, RGBA


def _unfilter_sequential(ftype: int, line: bytearray, prev: bytes, bpp: int) -> bytearray:
    """Average (3) and Paeth (4): each byte depends on the one decoded bpp
    before it, so they are undone byte by byte."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 255
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        line[i] = (line[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
    return line


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        d = f.read()
    if d[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, hdr, idat = 8, None, []
    while pos + 8 <= len(d):
        n, kind = struct.unpack_from(">I4s", d, pos)
        body = d[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", d, pos + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR")
    w, h, depth, ctype, comp, filt, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or comp or filt or interlace:
        raise ValueError(f"{path}: only 8-bit greyscale/RGB/RGBA non-interlaced PNG is "
                         f"supported (depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _PNG_CHANNELS[ctype]
    stride = w * c
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    rows = np.frombuffer(raw[:h * (stride + 1)], np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum of each channel along the row
            cur = np.cumsum(line.reshape(w, c), axis=0, dtype=np.uint8).reshape(stride)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(ftype, bytearray(line.tobytes()),
                                                     prev.tobytes(), c), np.uint8)
        else:
            raise ValueError(f"{path}: bad row filter {ftype}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, c) if c > 1 else out.reshape(h, w)


def write_png(path: str, arr: np.ndarray) -> None:
    """[H, W] or [H, W, 1|3|4] uint8; every row with filter 0."""
    a = np.ascontiguousarray(arr)
    if a.dtype != np.uint8:
        raise TypeError(f"PNG: want uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    c = 1 if a.ndim == 2 else a.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None or a.ndim not in (2, 3):
        raise ValueError(f"PNG: want [H, W] or [H, W, 1|3|4], got {a.shape}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# the package's interface
# ---------------------------------------------------------------------------


def _kind(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        return "tiff"
    if ext == ".png":
        return "png"
    raise ValueError(f"{path}: only .tif/.tiff and .png are supported")


def imread(path: str) -> np.ndarray:
    img = read_tiff(path) if _kind(path) == "tiff" else read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    return img


def imwrite(path: str, arr: np.ndarray) -> None:
    kind = _kind(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    (write_tiff if kind == "tiff" else write_png)(path, np.asarray(arr))


def load_image(path: str, bit_depth: int = 12) -> np.ndarray:
    """Read and normalize to [0, 1] by 2**bits - 1 (reference:
    library.py:117-129)."""
    return imread(path).astype(np.float32) / (2.0 ** float(bit_depth) - 1.0)


def load_image_stack(paths: List[str], bit_depth: int = 12) -> np.ndarray:
    """A same-shape frame stack -> [N, H, W, C] float32 in [0, 1]."""
    return np.stack([load_image(p, bit_depth) for p in paths])


_EXTS = ["*.tiff", "*.tif", "*.png", "*.jpg", "*.jpeg", "*.raw"]


def list_video_files(d: str) -> List[str]:
    """Sorted frame paths in a sequence directory, first matching extension
    wins (reference: library.py:102-115)."""
    files = os.listdir(d)
    for pat in _EXTS:
        hits = sorted(fnmatch.filter(files, pat))
        if hits:
            return [os.path.join(d, p) for p in hits]
    raise FileNotFoundError(f"no frames in {d}")


def list_sequence_dirs(root: str, videos: Optional[str] = None) -> List[str]:
    """Sorted sequence subdirectories, optionally filtered by a comma list."""
    names = None if videos is None else set(videos.split(","))
    out = []
    for e in os.scandir(root):
        if e.name.startswith(".") or not e.is_dir():
            continue
        if names is None or e.name in names:
            out.append(e.path)
    return sorted(out)
