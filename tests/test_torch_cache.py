"""The port's kernel-build cache (``gemm_hls_tpu_torch/tools/cache.py``) on
the CPU: a package / unpackage round trip of a fake hashed library, which
then loads with no nvcc, and one whose hash does not match the sources,
which is never loaded.  The real library's round trip runs on the card
(``chip_smoke.py`` phase 26d)."""

import tarfile

import pytest

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.tools import cache


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """A build directory holding a fake library under the sources' hash,
    its log and a half-linked library; nvcc refused."""
    d = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", d)
    monkeypatch.setattr(cache, "_enabled_dir", None)
    monkeypatch.setattr(cache, "DEFAULT_CACHE_DIR", str(tmp_path / "default"))

    def no_nvcc():
        raise RuntimeError("nvcc was called")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    d.mkdir()
    lib = _build.library_path()
    lib.write_bytes(b"\x7fELF fake kernels")
    lib.with_suffix(".log").write_text("== mxu_gemm.cu: 1.0 s, rc 0\n")
    (d / "libgemm_hls_kernels_0123456789abcdef.so.99.tmp").write_bytes(b"partial")
    return d


def test_package_unpackage_round_trip(build_dir, tmp_path):
    lib = _build.library_path()
    archive = cache.package(str(tmp_path / "kernels.tar.gz"))
    with tarfile.open(archive) as tar:
        assert sorted(tar.getnames()) == sorted([lib.name, lib.with_suffix(".log").name])
    target = tmp_path / "unpacked"
    assert cache.unpackage(archive, str(target)) == str(target)
    assert _build.BUILD_DIR == target and cache.cache_dir() == str(target)
    # Same sources, same hash: the unpackaged library is the one built, no nvcc.
    assert _build.build() == target / lib.name
    assert (target / lib.name).read_bytes() == lib.read_bytes()


def test_a_library_of_other_sources_is_never_loaded(build_dir, tmp_path):
    lib = _build.library_path()
    stale = lib.with_name("libgemm_hls_kernels_0000000000000000.so")
    lib.rename(stale)
    archive = cache.package(str(tmp_path / "stale.tar.gz"))
    cache.unpackage(archive, str(tmp_path / "unpacked"))
    assert (tmp_path / "unpacked" / stale.name).exists()
    with pytest.raises(RuntimeError, match="nvcc was called"):
        _build.build()  # the sources' hash names another file: it rebuilds


def test_enable_persistent_cache_defaults(build_dir, tmp_path):
    d = cache.enable_persistent_cache(min_compile_time_secs=5.0)
    assert d == str(tmp_path / "default") and _build.BUILD_DIR == tmp_path / "default"
    assert _build.library_path().parent == tmp_path / "default"
    with pytest.raises(FileNotFoundError):
        cache.package(str(tmp_path / "x.tar.gz"), str(tmp_path / "nothing"))
