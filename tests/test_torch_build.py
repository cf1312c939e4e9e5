"""When rvdd_tpu_torch/_build.py rebuilds a CUDA library: a library is stale
when it is missing, or older than its source or than any header in csrc/.
No nvcc is needed: the tests point the build at temporary directories and
set file times."""

import os

import pytest

pytest.importorskip("torch")

from rvdd_tpu_torch import _build  # noqa: E402


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    for f in (csrc / "k.cu", csrc / "other.cu", csrc / "wgmma.cuh", csrc / "more.cuh"):
        f.write_text("// source\n")
        os.utime(f, (1000, 1000))
    return csrc, build


def _touch(path, t):
    path.write_text("x")
    os.utime(path, (t, t))


def test_missing_library_is_stale(dirs):
    assert _build._stale("k")


def test_library_newer_than_everything_is_fresh(dirs):
    _, build = dirs
    _touch(build / "libk.so", 2000)
    assert not _build._stale("k")


@pytest.mark.parametrize("newer", ["k.cu", "wgmma.cuh", "more.cuh"])
def test_newer_source_or_header_makes_it_stale(dirs, newer):
    csrc, build = dirs
    _touch(build / "libk.so", 2000)
    os.utime(csrc / newer, (3000, 3000))
    assert _build._stale("k")


def test_another_source_does_not_make_it_stale(dirs):
    csrc, build = dirs
    _touch(build / "libk.so", 2000)
    os.utime(csrc / "other.cu", (3000, 3000))
    assert not _build._stale("k")


# ------------------------------------------------ the host route (csrc/*.cpp)


@pytest.fixture
def cpp_dirs(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    for f in (csrc / "h.cpp", csrc / "io.h", csrc / "wgmma.cuh"):
        f.write_text("// source\n")
        os.utime(f, (1000, 1000))
    return csrc, build


def test_cpp_source_is_the_host_route(cpp_dirs):
    csrc, build = cpp_dirs
    assert _build.source_path("h") == csrc / "h.cpp"
    cmd = _build._command(csrc / "h.cpp", build / "libh.so")
    assert cmd[1:] == [*_build.CXX_FLAGS, "-o", str(build / "libh.so"), str(csrc / "h.cpp")]
    assert "nvcc" not in cmd[0]


@pytest.mark.parametrize("newer,stale", [(None, False), ("h.cpp", True), ("io.h", True),
                                         ("wgmma.cuh", False)])
def test_cpp_staleness_rule(cpp_dirs, newer, stale):
    """Missing or older than its source or a host header (``*.h``); the
    CUDA headers do not touch a host library."""
    csrc, build = cpp_dirs
    assert _build._stale("h")
    _touch(build / "libh.so", 2000)
    if newer:
        os.utime(csrc / newer, (3000, 3000))
    assert _build._stale("h") == stale


def test_cpp_build_then_a_broken_source_raises(cpp_dirs, monkeypatch):
    """g++ builds a good source into _build/ (loadable); a broken one raises
    with the compiler's output and leaves no temporary file and the old
    library in place."""
    import ctypes

    csrc, build = cpp_dirs
    monkeypatch.delenv("CXX", raising=False)
    (csrc / "h.cpp").write_text('extern "C" int twice(int x) { return 2 * x; }\n')
    _build.build(("h",))
    lib = ctypes.CDLL(str(build / "libh.so"))
    assert lib.twice(21) == 42
    before = (build / "libh.so").read_bytes()
    (csrc / "h.cpp").write_text('extern "C" int twice(int x) { return 2 * undeclared; }\n')
    with pytest.raises(RuntimeError, match="undeclared") as err:
        _build.build(("h",))
    assert "h.cpp" in str(err.value)
    assert (build / "libh.so").read_bytes() == before
    assert sorted(p.name for p in build.iterdir()) == ["libh.so"]
