"""The port's kernel-build cache (``gemm_hls_tpu_torch/tools/cache.py``) on
the CPU: a package / unpackage round trip of a fake hashed library, which
then loads with no nvcc, and one whose hash does not match the sources,
which is never loaded; the generated libraries of user semirings and
callable epilogues (``ops/codegen.py``) likewise.  The real libraries'
round trips run on the card (``chip_smoke.py`` phases 26d and 31a)."""

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


def test_generated_libraries_travel_with_the_cache(build_dir, tmp_path, monkeypatch):
    import torch

    from gemm_hls_tpu_torch import Semiring
    from gemm_hls_tpu_torch.ops import codegen

    src = codegen.semiring_source(
        Semiring("plus_max", torch.maximum, torch.add, 0, None, None), torch.float32,
        torch.float32)
    gen = _build.generated_path(src)
    assert gen.parent == build_dir and gen.name.startswith("libgemm_hls_gen_")
    gen.write_bytes(b"\x7fELF fake generated functor")
    gen.with_suffix(".log").write_text("== gen_x.cu: 2.0 s, rc 0\n")
    archive = cache.package(str(tmp_path / "kernels.tar.gz"))
    with tarfile.open(archive) as tar:
        assert {gen.name, gen.with_suffix(".log").name} <= set(tar.getnames())
    target = tmp_path / "unpacked"
    cache.unpackage(archive, str(target))
    loaded = []

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            fn.name = name
            return fn

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "_generated", {})
    monkeypatch.setattr(_build, "_generated_fns", {})
    before = _build.generated_builds
    fn = _build.generated_library(src, codegen.SEMIRING_ENTRY)
    # Found in the unpackaged directory under the text's hash: no nvcc.
    assert loaded == [str(target / gen.name)] and fn.name == codegen.SEMIRING_ENTRY
    assert fn.argtypes == _build.GENERATED_ARGTYPES[codegen.SEMIRING_ENTRY]
    assert _build.generated_builds == before
    assert _build.generated_library(src, codegen.SEMIRING_ENTRY) is not None
    assert len(loaded) == 1  # a second lookup in the process loads nothing
    with pytest.raises(RuntimeError, match="nvcc was called"):
        _build.generated_library(src.replace("plus_max", "other"), codegen.SEMIRING_ENTRY)
