"""The port's host-staged GEMMs (``parallel/staging.py``) against
``gemm_hls_tpu.parallel.staging`` on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_parallel.py`` does; the port runs with ``device="cpu"`` (the
plain versions, through the same host-tile schedule).  Shapes and host
tiles are the JAX tests' (``tests/test_parallel.py:116-205``): ragged in N
and K.  Tolerances: rel 1e-3 for float plus_times (different summation
orders inside a panel), exact for min_plus (each term rounds alike, min
is exact), bitwise between prefetch and sync, 1e-13 normwise for the
streamed Ozaki GEMM.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from gemm_hls_tpu.parallel import staging as jax_staging

from gemm_hls_tpu_torch.parallel import staging
from gemm_hls_tpu_torch.utils import make_operands, reference_matmul, verify_matmul

torch.set_num_threads(1)

CPU = "cpu"


@pytest.mark.parametrize("shape,tiles", [
    ((96, 80, 112), (32, 48, 64)),     # test_streamed_matmul_out_of_core
    ((80, 64, 96), (32, 32, 32)),      # test_streamed_matmul_prefetch_matches_sync
    ((40, 40, 40), (64, 64, 64)),      # one tile: the whole problem
])
def test_plus_times_matches_jax(shape, tiles):
    m, n, k = shape
    tm, tn, tk = tiles
    a, b = make_operands(m, n, k, "float32")
    got = staging.streamed_matmul(a, b, tile_m=tm, tile_n=tn, tile_k=tk, device=CPU)
    want = jax_staging.streamed_matmul(a, b, tile_m=tm, tile_n=tn, tile_k=tk)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3)
    verify_matmul(got, reference_matmul(a, b))


def test_min_plus_matches_jax_exactly():
    a, b = make_operands(48, 40, 56, "float32")
    kw = dict(semiring="min_plus", tile_m=16, tile_n=16, tile_k=32)
    got = staging.streamed_matmul(a, b, device=CPU, **kw)
    want = jax_staging.streamed_matmul(a, b, **kw)
    np.testing.assert_array_equal(got, want)
    verify_matmul(got, reference_matmul(a, b, semiring="min_plus"))


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_matches_sync_bitwise(monkeypatch, semiring, depth):
    a, b = make_operands(80, 64, 96, "float32")
    kw = dict(semiring=semiring, tile_m=32, tile_n=32, tile_k=32, device=CPU)
    sync = staging.streamed_matmul(a, b, prefetch=False, **kw)
    assert staging.streamed_matmul.last_stats["prefetch"] is False
    monkeypatch.setattr(staging, "PREFETCH_DEPTH", depth)
    got = staging.streamed_matmul(a, b, prefetch=True, **kw)
    stats = staging.streamed_matmul.last_stats
    assert stats["prefetch"] is True and stats["slots"] == depth + 1
    np.testing.assert_array_equal(got, sync)


def test_stats_count_the_ca_law():
    # Each (tile_m, tile_n) C tile streams its A rows and B columns over
    # the whole K once: M K ceil(N / tile_n) + K N ceil(M / tile_m) words in,
    # M N out.
    m, n, k, tm, tn, tk = 96, 80, 112, 32, 48, 64
    a, b = make_operands(m, n, k, "float32")
    staging.streamed_matmul(a, b, tile_m=tm, tile_n=tn, tile_k=tk, device=CPU)
    stats = staging.streamed_matmul.last_stats
    assert stats["jobs"] == 3 * 2 * 2
    assert stats["h2d_bytes"] == (m * k * 2 + k * n * 3) * 4
    assert stats["d2h_bytes"] == m * n * 4
    assert stats["routes"] == []  # no kernel runs on the CPU


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("enabled", [True, False])
def test_prefetched_order_and_depth_match_jax(depth, enabled):
    jobs = list(range(7))
    seen = {}
    for name, fn in (("port", staging._prefetched), ("jax", jax_staging._prefetched)):
        calls = []
        got = [(j, v) for j, v in fn(jobs, lambda j: calls.append(j) or j * 10,
                                     depth=depth, enabled=enabled)]
        assert got == [(j, j * 10) for j in jobs]
        assert calls == jobs  # staged in order, each exactly once
        seen[name] = got
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("panel,acc,depth", [
    (100, 100, 2), (300, 100, 2), (150, 150, 2), (200, 0, 1), (133, 201, 3),
    (1 << 30, 1 << 28, 2), (3 << 30, 1 << 30, 2)])
def test_prefetch_fits_matches_jax(monkeypatch, panel, acc, depth):
    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 1000}

    class NoStats:
        def memory_stats(self):
            raise RuntimeError("unsupported")

    # The CPU budget is the reference's 16 GiB default.
    assert staging._prefetch_fits(panel, acc, CPU, depth) == \
        jax_staging._prefetch_fits(panel, acc, NoStats(), depth)
    monkeypatch.setattr(staging, "_device_bytes_limit", lambda device: 1000)
    assert staging._prefetch_fits(panel, acc, CPU, depth) == \
        jax_staging._prefetch_fits(panel, acc, Dev(), depth)


def test_device_bytes_limit_on_the_cpu():
    assert staging._device_bytes_limit(CPU) == 16 * 1024**3


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_bf16_cpu_tensors(out_dtype):
    # numpy has no bfloat16 on the card machine: bf16 operands are CPU
    # tensors, and the result comes back as one.  Held to JAX on the same
    # values as ml_dtypes arrays.
    a, b = make_operands(64, 48, 200, "float32")
    at, bt = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    kw = dict(tile_m=32, tile_n=32, tile_k=64)
    got = staging.streamed_matmul(at, bt, out_dtype=out_dtype, device=CPU, **kw)
    assert isinstance(got, torch.Tensor)
    assert got.dtype == (out_dtype or torch.bfloat16)
    want = jax_staging.streamed_matmul(
        at.float().numpy().astype(ml_dtypes.bfloat16),
        bt.float().numpy().astype(ml_dtypes.bfloat16),
        out_dtype=None if out_dtype is None else "float32", **kw)
    rtol = 1e-3 if out_dtype is not None else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=rtol)


def test_numpy_bf16_result_is_refused():
    a, b = make_operands(8, 8, 8, "float32")
    with pytest.raises(ValueError, match="bfloat16"):
        staging.streamed_matmul(a, b, out_dtype="bfloat16", device=CPU)


def test_contraction_mismatch_raises_like_jax():
    a, b = make_operands(8, 8, 8, "float32")
    with pytest.raises(ValueError, match="contraction mismatch"):
        staging.streamed_matmul(a, b[:4], device=CPU)
    with pytest.raises(ValueError, match="contraction mismatch"):
        jax_staging.streamed_matmul(a, b[:4])


def test_streamed_ozaki_matches_jax():
    rng = np.random.default_rng(11)
    a = rng.uniform(-5, 5, (300, 700))
    b = rng.uniform(-5, 5, (700, 260))
    kw = dict(tile_m=128, tile_n=128, tile_k=256)
    got = staging.streamed_ozaki_matmul(a, b, device=CPU, **kw)
    want = jax_staging.streamed_ozaki_matmul(a, b, **kw)
    scale = (np.linalg.norm(a, axis=1)[:, None] * np.linalg.norm(b, axis=0)[None, :])
    assert (np.abs(got - a @ b) / scale).max() < 1e-13
    assert (np.abs(got - want) / scale).max() < 1e-13
