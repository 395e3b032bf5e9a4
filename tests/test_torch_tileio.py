"""The port's tile IO (``utils/tileio.py``) and disk-resident GEMM
(``parallel.streamed_matmul_files``) against ``gemm_hls_tpu``'s, the 8
cases of ``tests/test_tileio.py``: each side runs on its own copy of the
same files.  The JAX GEMM runs in interpret mode, the port's with
``device="cpu"``.  Tolerances: file bytes exact, plus_times rel 1e-3 between
the two and against the float64 oracle, min_plus exact.
"""

import shutil

import numpy as np
import pytest

from gemm_hls_tpu.parallel import streamed_matmul_files as jax_streamed_files
from gemm_hls_tpu.utils import tileio as jax_tileio

from gemm_hls_tpu_torch.parallel import streamed_matmul_files
from gemm_hls_tpu_torch.utils import make_operands, reference_matmul, verify_matmul
from gemm_hls_tpu_torch.utils import tileio

SIDES = {"port": tileio.MatrixFile, "jax": jax_tileio.MatrixFile}


def test_native_lib_builds():
    assert tileio.native_tileio_available()
    assert tileio._LIB_PATH == jax_tileio._LIB_PATH  # one shared library


def test_roundtrip_tiles_across_packages(tmp_path):
    data = np.arange(48 * 32, dtype=np.float32).reshape(48, 32)
    with tileio.MatrixFile(tmp_path / "m.bin", 48, 32, np.float32, create=True) as mf:
        assert mf.native
        mf.write_tile(0, 0, data)
    shutil.copy(tmp_path / "m.bin", tmp_path / "copy.bin")
    for name, cls in SIDES.items():
        path = tmp_path / ("m.bin" if name == "port" else "copy.bin")
        with cls(path, 48, 32, np.float32) as mf:
            np.testing.assert_array_equal(mf.read_tile(0, 48, 0, 32), data)
            np.testing.assert_array_equal(mf.read_tile(10, 20, 5, 17), data[10:20, 5:17])


def test_write_subtiles_same_bytes(tmp_path):
    for name, cls in SIDES.items():
        with cls(tmp_path / f"{name}.bin", 16, 16, np.float32, create=True) as mf:
            mf.write_tile(0, 0, np.zeros((16, 16), np.float32))
            mf.write_tile(4, 8, np.full((4, 8), 7.0, np.float32))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    exp = np.zeros((16, 16), np.float32)
    exp[4:8, 8:16] = 7.0
    with tileio.MatrixFile(tmp_path / "port.bin", 16, 16, np.float32) as mf:
        np.testing.assert_array_equal(mf.read_tile(0, 16, 0, 16), exp)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_out_of_bounds_rejected(tmp_path, side):
    with SIDES[side](tmp_path / "m.bin", 8, 8, np.float32, create=True) as mf:
        with pytest.raises(ValueError, match="tileio_read_tile"):
            mf.read_tile(0, 9, 0, 8)


def test_read_into_a_given_buffer(tmp_path):
    data = np.arange(12 * 10, dtype=np.float32).reshape(12, 10)
    with tileio.MatrixFile(tmp_path / "m.bin", 12, 10, np.float32, create=True) as mf:
        mf.write_tile(0, 0, data)
        buf = np.empty((5, 4), np.float32)
        assert mf.read_tile(3, 8, 2, 6, out=buf) is buf
        np.testing.assert_array_equal(buf, data[3:8, 2:6])
        with pytest.raises(ValueError, match="C-contiguous"):
            mf.read_tile(3, 8, 2, 6, out=np.empty((4, 5), np.float32))
        with pytest.raises(ValueError, match="C-contiguous"):
            mf.read_tile(3, 8, 2, 6, out=np.empty((5, 8), np.float32)[:, :4])


def _gemm_files(tmp_path, a, b, tag):
    m, k = a.shape
    n = b.shape[1]
    files = []
    for name, rows, cols in (("a", m, k), ("b", k, n), ("c", m, n)):
        files.append(tileio.MatrixFile(tmp_path / f"{tag}{name}.bin", rows, cols,
                                       np.float32, create=True))
    files[0].write_tile(0, 0, a)
    files[1].write_tile(0, 0, b)
    for f in files:
        f.close()
    return [tmp_path / f"{tag}{name}.bin" for name in "abc"]


@pytest.mark.parametrize("shape,semiring,tiles", [
    ((96, 80, 112), "plus_times", (32, 48, 64)),    # test_disk_resident_gemm
    ((40, 48, 56), "min_plus", (16, 16, 32)),       # test_disk_resident_semiring
])
def test_disk_resident_gemm_matches_jax(tmp_path, shape, semiring, tiles):
    m, n, k = shape
    tm, tn, tk = tiles
    a, b = make_operands(m, n, k, "float32")
    paths = _gemm_files(tmp_path, a, b, "p")
    for p in paths:
        shutil.copy(p, tmp_path / ("j" + p.name[1:]))
    results = {}
    for name, cls, fn, tag in (
            ("port", tileio.MatrixFile, streamed_matmul_files, "p"),
            ("jax", jax_tileio.MatrixFile, jax_streamed_files, "j")):
        with cls(tmp_path / f"{tag}a.bin", m, k, np.float32) as fa, \
             cls(tmp_path / f"{tag}b.bin", k, n, np.float32) as fb, \
             cls(tmp_path / f"{tag}c.bin", m, n, np.float32, writable=True) as fc:
            kw = dict(device="cpu") if name == "port" else {}
            fn(fa, fb, fc, semiring=semiring, tile_m=tm, tile_n=tn, tile_k=tk, **kw)
            results[name] = fc.read_tile(0, m, 0, n)
    verify_matmul(results["port"], reference_matmul(a, b, semiring=semiring))
    if semiring == "min_plus":
        np.testing.assert_array_equal(results["port"], results["jax"])
    else:
        np.testing.assert_allclose(results["port"], results["jax"], rtol=1e-3)


def test_memmap_fallback_gives_the_same_product(tmp_path, monkeypatch):
    a, b = make_operands(40, 48, 56, "float32")
    native = _gemm_files(tmp_path, a, b, "n")
    fallback = _gemm_files(tmp_path, a, b, "f")
    for paths, lib in ((native, None), (fallback, "memmap")):
        if lib:
            monkeypatch.setattr(tileio, "_get_lib", lambda: None)
        with tileio.MatrixFile(paths[0], 40, 56, np.float32) as fa, \
             tileio.MatrixFile(paths[1], 56, 48, np.float32) as fb, \
             tileio.MatrixFile(paths[2], 40, 48, np.float32, writable=True) as fc:
            assert fc.native == (lib is None)
            streamed_matmul_files(fa, fb, fc, tile_m=16, tile_n=32, tile_k=32,
                                  device="cpu")
    assert paths[2].read_bytes() == native[2].read_bytes()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_too_small_file_rejected_at_open(tmp_path, side):
    # A file smaller than the declared geometry fails at open with an
    # OSError, not a SIGBUS on the first access out of range.
    p = tmp_path / "small.bin"
    p.write_bytes(b"\x00" * 64)
    with pytest.raises(OSError):
        SIDES[side](p, 64, 64, np.float32)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_overflowing_geometry_rejected(tmp_path, side):
    p = tmp_path / "m.bin"
    with SIDES[side](p, 8, 8, np.float32, create=True):
        pass
    with pytest.raises((OSError, OverflowError, ValueError)):
        SIDES[side](p, 2**62, 2**62, np.float32)


def test_shape_mismatch_rejected(tmp_path):
    paths = _gemm_files(tmp_path, *make_operands(8, 8, 8, "float32"), "s")
    with tileio.MatrixFile(paths[0], 8, 8, np.float32) as fa, \
         tileio.MatrixFile(paths[1], 8, 8, np.float32) as fb, \
         tileio.MatrixFile(paths[2], 8, 4, np.float32) as fc:
        with pytest.raises(ValueError, match="shape mismatch"):
            streamed_matmul_files(fa, fb, fc, device="cpu")
