"""The port's host decode pool (rvdd_tpu_torch/csrc/rvdd_io.cpp through
data/native.py) against the port's numpy reader and rvdd_tpu's readers, and
load_image_stack's choice of route.

The pool divides by the scale in float32 (v / scale), as numpy divides a
float32 array by a float, so its values equal the port's numpy reader and
rvdd_tpu's imageio ``load_image`` bit for bit.  rvdd_tpu's own pool
(native/rvdd_io.cpp) multiplies by the float32 reciprocal 1 / scale, which
rounds twice, so it may differ from both by one ulp; that is the bound the
comparison with it states."""

import struct
import subprocess

import numpy as np
import pytest

from rvdd_tpu.data import io as jio
from rvdd_tpu.data import native as jnative
from rvdd_tpu_torch import _build
from rvdd_tpu_torch.data import io, native

SCALE = 2.0 ** 12 - 1.0


def _arr(rng, shape, dtype):
    if dtype == np.uint16:
        return rng.integers(0, 4096, shape).astype(np.uint16)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.uniform(0, 4095, shape).astype(np.float32)


def _tiff(a: np.ndarray, bo: str = "<", rows: int = 4, reverse: bool = False) -> bytes:
    """A classic TIFF of [H, W, C] in byte order ``bo``, ``rows`` rows a
    strip, the strips stored in reverse order if ``reverse`` (so the pool
    must join them from their offsets)."""
    h, w, c = a.shape
    row = w * c * a.dtype.itemsize
    starts = list(range(0, h, rows))
    chunks = [a[y:y + rows].astype(a.dtype.newbyteorder(bo)).tobytes() for y in starts]
    order = list(reversed(range(len(chunks)))) if reverse else list(range(len(chunks)))
    offsets, at = [0] * len(chunks), 8
    for k in order:
        offsets[k], at = at, at + len(chunks[k])
    data = b"".join(chunks[k] for k in order)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [a.dtype.itemsize * 8] * c), (259, 3, [1]),
            (262, 3, [1]), (273, 4, offsets), (277, 3, [c]), (278, 4, [rows]),
            (279, 4, [min(rows, h - y) * row for y in starts]),
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


@pytest.fixture(scope="module")
def rvdd_tpu_pool(tmp_path_factory):
    """rvdd_tpu's NativeLoader over its own native/rvdd_io.cpp, built here
    with g++ (the repo's native/ is left as it is)."""
    out = tmp_path_factory.mktemp("native") / "librvdd_io.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-pthread", "-shared", "-o", str(out),
                    str(_build.PKG_DIR.parent / "native" / "rvdd_io.cpp")], check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_LIB_PATHS", [str(out)])
    mp.setattr(jnative, "_lib", None)
    mp.setattr(jnative, "_lib", jnative._load_lib())
    yield jnative.NativeLoader(2)
    mp.undo()


def test_pool_builds_with_gxx_into_build_dir():
    lib = native.library()
    assert _build.lib_path("rvdd_io").exists()
    assert not _build._stale("rvdd_io")
    assert hasattr(lib, "rvdd_pool_read_batch")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_decode_bit_equal_to_numpy_and_imageio(tmp_path, rvdd_tpu_pool, dtype, c):
    """Exact (bit for bit) against the port's read_tiff and rvdd_tpu's
    imageio load_image, raw and scaled; within 1 ulp of rvdd_tpu's pool,
    whose reciprocal rounds twice.  rvdd_tpu's pool is not asked for 2
    samples: it reads a BitsPerSample of two values, which the file holds
    inline, as an offset (native/rvdd_io.cpp:87-89) and faults; its
    datasets never hold such a file (imageio writes 2 channels as pages)."""
    a = _arr(np.random.default_rng(c), (13, 17, c), dtype)
    p = str(tmp_path / "f.tiff")
    io.imwrite(p, a)
    want = io.load_image(p)
    assert want.shape == (13, 17, c)
    np.testing.assert_array_equal(io.read_tiff(p).reshape(13, 17, c), a)
    raw = native.read_image(p)
    np.testing.assert_array_equal(raw, a.astype(np.float32))
    got = native.read_image(p, SCALE)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    ref = jio.load_image(p)
    assert got.view(np.uint32).tolist() == ref.reshape(got.shape).view(np.uint32).tolist()
    if c != 2:
        theirs = rvdd_tpu_pool.read_batch([p], got.shape, scale=SCALE)[0]
        ulps = np.abs(theirs.view(np.int32).astype(np.int64) - got.view(np.int32))
        assert ulps.max() <= 1


@pytest.mark.parametrize("bo", ["<", ">"])
def test_strips_out_of_order(tmp_path, bo):
    """Several strips stored in reverse order: little-endian goes through
    the pool, which joins them by their offsets; big-endian is outside its
    subset and goes through the numpy reader.  Both equal imageio."""
    a = _arr(np.random.default_rng(5), (19, 11, 3), np.uint16)
    p = tmp_path / "s.tif"
    p.write_bytes(_tiff(a, bo, rows=4, reverse=True))
    want = jio.load_image(str(p))
    got = io.load_image_stack([str(p), str(p)])
    assert got.view(np.uint32).tolist() == np.stack([want, want]).view(np.uint32).tolist()
    assert (io.native_shape(str(p)) is not None) == (bo == "<")
    if bo == ">":
        with pytest.raises(IOError):
            native.read_image(str(p), SCALE)


def test_batch_of_five_on_three_workers(tmp_path):
    rng = np.random.default_rng(0)
    frames = [_arr(rng, (12, 17, 4), np.float32) for _ in range(5)]
    paths = []
    for i, a in enumerate(frames):
        paths.append(str(tmp_path / f"{i:03d}.tiff"))
        io.imwrite(paths[-1], a)
    loader = native.NativeLoader(workers=3)
    try:
        got = loader.read_batch(paths, (12, 17, 4), scale=SCALE)
        raw = loader.read_batch(paths, (12, 17, 4))
    finally:
        loader.close()
    np.testing.assert_array_equal(raw, np.stack(frames))
    want = np.stack(frames) / np.float32(SCALE)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()


def test_missing_file_and_wrong_shape_raise_ioerror(tmp_path):
    a = _arr(np.random.default_rng(1), (8, 9, 3), np.uint16)
    good = str(tmp_path / "a.tiff")
    io.imwrite(good, a)
    io.imwrite(str(tmp_path / "b.tiff"), a[:, :8])
    with pytest.raises(IOError, match="missing.tiff"):
        native.read_image(str(tmp_path / "missing.tiff"))
    loader = native.NativeLoader(workers=2)
    try:
        with pytest.raises(IOError, match="missing.tiff"):
            loader.read_batch([good, str(tmp_path / "missing.tiff")], (8, 9, 3), SCALE)
        with pytest.raises(IOError, match="b.tiff"):
            loader.read_batch([good, str(tmp_path / "b.tiff")], (8, 9, 3), SCALE)
    finally:
        loader.close()
    # a stack whose first header is in the subset: the pool's failure raises
    with pytest.raises(IOError, match="b.tiff"):
        io.load_image_stack([good, str(tmp_path / "b.tiff")])


def _multipage_flow(tmp_path):
    """A 2-channel flow as imageio's Pillow writer stores it: H pages."""
    fl = np.random.default_rng(2).standard_normal((6, 7, 2)).astype(np.float32)
    p = str(tmp_path / "flow.tif")
    jio.imwrite(p, fl)
    return p


def test_other_files_take_the_numpy_route(tmp_path, monkeypatch):
    """PNG, big-endian TIFF and multi-page TIFF: native_shape is None, the
    pool is never asked, and the stack equals rvdd_tpu's reads."""
    rng = np.random.default_rng(3)
    png = str(tmp_path / "a.png")
    io.imwrite(png, _arr(rng, (9, 10, 3), np.uint8))
    be = tmp_path / "be.tif"
    be.write_bytes(_tiff(_arr(rng, (9, 10, 3), np.float32), ">"))
    multi = _multipage_flow(tmp_path)

    def refuse():
        raise AssertionError("the pool was asked")

    monkeypatch.setattr(io, "native_loader", refuse)
    for p in (png, str(be), multi):
        assert io.native_shape(p) is None
        got = io.load_image_stack([p, p], bit_depth=8)
        want = jio.load_image(p, 8)
        assert got.view(np.uint32).tolist() == np.stack([want, want]).view(np.uint32).tolist()
    with pytest.raises(IOError):
        native.read_image(multi)


def test_subset_stack_takes_the_pool_route(tmp_path, monkeypatch):
    """A stack of the subset goes through one NativeLoader of the process,
    as one batch, and equals rvdd_tpu's load_image_stack."""
    rng = np.random.default_rng(4)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"{i}.tiff"))
        io.imwrite(paths[-1], _arr(rng, (10, 12, 4), np.uint16))
    calls = []
    real = native.NativeLoader.read_batch

    def spy(self, ps, shape, scale=0.0):
        calls.append((len(ps), tuple(shape), scale))
        return real(self, ps, shape, scale)

    monkeypatch.setattr(native.NativeLoader, "read_batch", spy)
    got = io.load_image_stack(paths)
    assert calls == [(4, (10, 12, 4), SCALE)]
    assert io.native_loader() is io.native_loader()
    assert io.native_loader().workers == io.NATIVE_WORKERS == 4
    want = jio.load_image_stack(paths)
    np.testing.assert_array_equal(got, np.stack([jio.load_image(p) for p in paths]))
    assert np.abs(got - want).max() <= np.spacing(np.float32(1.0))
