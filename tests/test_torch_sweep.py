"""The port's sweep manager (``gemm_hls_tpu_torch/tools/sweep.py``) on the
CPU: ``expand_grid``, the CSV schema and ``merge_csvs`` against the JAX
package's (``gemm_hls_tpu.tools.sweep``) on the same inputs, exact; the
taxonomy and resume on the plain versions (``platform="cpu"``: verified,
not timed, since a CPU time is no reading of the card); a process-isolated
scan that survives a crashing ``setup_code``.  Timed sweeps run on the card
(``chip_smoke.py`` phase 26b).
"""

import json

import pytest

from gemm_hls_tpu.tools import sweep as jsweep
from gemm_hls_tpu_torch.config import default_config
from gemm_hls_tpu_torch.tools import sweep

SIMT = default_config("float32")           # the CUDA-core tile (128, 128, 16)
WMMA = default_config("bfloat16")          # the WMMA tile (128, 128, 32)


def test_expand_grid_matches_jax():
    axes = dict(block_m=[128, 256], block_n=[128], block_k=[16, 32, 64],
                dtype=["float32", "bfloat16"], precision=["high"])
    assert sweep.expand_grid(**axes) == jsweep.expand_grid(**axes)
    assert len(sweep.expand_grid(**axes)) == 12


def test_csv_schema_matches_jax():
    assert sweep.SweepResult.CSV_COLS == jsweep.SweepResult.CSV_COLS
    row = sweep.SweepResult(SIMT, "ok", seconds=1.25e-5, gflops=0.0123456, m=1, n=2,
                            k=3).csv_row()
    assert list(row) == list(sweep.SweepResult.CSV_COLS)
    # Six significant digits: a resumed reading compares at rel 1e-2 whatever
    # its size (the reference's two decimals keep "0.01" of this one).
    assert float(row["gflops"]) == pytest.approx(0.0123456, rel=1e-5)
    assert float(row["seconds"]) == pytest.approx(1.25e-5, rel=1e-5)


def _csvs(tmp_path):
    """Three CSVs: the port's, the JAX package's legacy schema (no m, n, k)
    and an overlapping one whose rows must collapse to the best evidence."""
    a = tmp_path / "port.csv"
    sweep.to_csv([sweep.SweepResult(SIMT, "ok", seconds=0.5, gflops=12.5, m=64, n=64, k=64),
                  sweep.SweepResult(WMMA, "invalid_config", detail="no tile", m=64, n=64,
                                    k=64)], str(a))
    legacy = tmp_path / "legacy.csv"
    legacy.write_text("dtype,semiring,block_m,block_n,block_k,precision,status,seconds,"
                      "gflops,max_rel_err,detail,extra\n"
                      "float32,plus_times,16,128,64,default,ok,0.01,3.50,,,x\n"
                      "float32,plus_times,16,128,64,default,crashed,,,,boom,y\n")
    again = tmp_path / "again.csv"
    sweep.to_csv([sweep.SweepResult(SIMT, "crashed", m=64, n=64, k=64),
                  sweep.SweepResult(WMMA, "ok", seconds=0.1, gflops=99.0, m=64, n=64,
                                    k=64)], str(again))
    return [str(a), str(legacy), str(again)]


def test_merge_csvs_matches_jax(tmp_path):
    paths = _csvs(tmp_path)
    got = sweep.merge_csvs(paths, str(tmp_path / "merged.csv"))
    assert got == jsweep.merge_csvs(paths)
    assert (tmp_path / "merged.csv").read_bytes().decode() == got
    lines = got.strip().splitlines()
    assert lines[0].split(",")[-1] == "extra" and len(lines) == 4
    # ok beats a failure; the higher GOp/s among ok rows.
    assert ",ok," in lines[1] and "12.5" in lines[1]
    assert ",ok," in lines[2] and "99" in lines[2]
    assert ",ok," in lines[3] and "3.50" in lines[3]
    assert sweep.merge_csvs(paths[:1] * 2) == jsweep.merge_csvs(paths[:1] * 2)


def test_run_one_taxonomy_on_the_plain_versions():
    kw = dict(platform="cpu", iters=0)
    ok = sweep.run_one(SIMT, 130, 70, 33, **kw)
    assert ok.status == "ok" and ok.max_rel_err <= 1e-3 and (ok.m, ok.n, ok.k) == (130, 70, 33)
    assert sweep.run_one(WMMA, 64, 64, 64, **kw).status == "ok"
    assert sweep.run_one(SIMT.replace(semiring="min_plus"), 64, 64, 64, **kw).status == "ok"
    bad = sweep.run_one(WMMA.replace(block_n=256), 64, 64, 64, **kw)
    assert bad.status == "invalid_config" and "compiled tile" in bad.detail
    big = sweep.run_one(WMMA.replace(block_m=512, block_n=512, block_k=128), 64, 64, 64, **kw)
    assert big.status == "vmem_overflow" and "shared memory" in big.detail
    assert sweep.run_one(SIMT, 32, 32, 32, platform="cpu", iters=1, timeout_s=1e-4,
                         retries=1).status == "timeout"


def test_in_process_timeout_always_reads_timeout():
    # Wherever the alarm lands (inside the GEMM's own ``except Exception``,
    # in a gc callback that swallows it), a call whose alarm fired reads
    # "timeout": never "crashed", never "ok".
    got = [sweep.run_one(SIMT, 32, 32, 32, platform="cpu", iters=1, timeout_s=1e-4,
                         retries=1).status for _ in range(100)]
    assert not {"crashed", "ok"} & set(got), got


def test_classify_exception():
    assert sweep._classify_exception(RuntimeError("CUDA error: too many resources "
                                                  "requested for launch")) == "vmem_overflow"
    assert sweep._classify_exception(MemoryError("CUDA out of memory")) == "vmem_overflow"
    assert sweep._classify_exception(RuntimeError("nvcc failed:\n...")) == "compile_failed"
    assert sweep._classify_exception(ValueError("anything else")) == "crashed"


def test_sweep_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "sweep.csv")
    grid = [dict(block_m=128, block_n=128, block_k=16), dict(block_m=64, block_n=128,
                                                             block_k=16)]
    r1 = sweep.sweep(grid, 64, 64, 64, base=SIMT, platform="cpu", iters=0,
                     checkpoint_csv=ckpt)
    assert [r.status for r in r1] == ["ok", "invalid_config"]
    r2 = sweep.sweep(grid, 64, 64, 64, base=SIMT, platform="cpu", iters=0,
                     checkpoint_csv=ckpt)
    assert all("[resumed]" in r.detail for r in r2)
    assert [r.status for r in r2] == ["ok", "invalid_config"]
    assert sweep.best_result(r1) is None  # not timed on the CPU


def test_isolated_sweep_survives_a_crashing_child(tmp_path):
    crashed = sweep.run_one(SIMT, 64, 64, 64, isolation="process", platform="cpu",
                            iters=0, timeout_s=120, setup_code="import os; os._exit(42)")
    assert crashed.status == "crashed" and "42" in crashed.detail
    raised = sweep.run_one(SIMT, 64, 64, 64, isolation="process", platform="cpu",
                           iters=0, timeout_s=120, setup_code="raise RuntimeError('x')")
    assert raised.status == "crashed" and "RuntimeError" in raised.detail
    grid = [dict(block_m=128, block_n=128, block_k=16), dict(block_m=256, block_n=256,
                                                             block_k=256)]
    res = sweep.sweep(grid, 64, 64, 64, base=SIMT, isolation="process", platform="cpu",
                      iters=0, workers=2, timeout_s=120,
                      checkpoint_csv=str(tmp_path / "iso.csv"))
    assert [r.status for r in res] == ["ok", "vmem_overflow"]
    assert [r.config.block_m for r in res] == [128, 256]


def test_cli_merge(tmp_path, capsys):
    paths = _csvs(tmp_path)
    out = tmp_path / "cli.csv"
    text = sweep.main(["merge", *paths, "-o", str(out)])
    assert out.read_bytes().decode() == text == jsweep.merge_csvs(paths)
    assert "3 files" in capsys.readouterr().out


def test_default_blocks_cover_the_compiled_tiles():
    assert sweep._default_blocks("bfloat16", "plus_times") == dict(
        block_m=[128], block_n=[128, 256], block_k=[32, 64])
    assert sweep._default_blocks("float32", "min_plus") == dict(
        block_m=[128], block_n=[128], block_k=[16])
    assert json.loads(json.dumps(sweep._default_blocks("int8", "plus_times")))
