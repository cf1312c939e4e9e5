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
