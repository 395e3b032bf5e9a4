"""The port's self-calibration (``gemm_hls_tpu_torch/tools/calibrate.py``)
and ``models/perf_model.detect_chip`` on a card without an entry, on the
CPU: ``fit_latch`` against the JAX package's on the same inputs, exact;
``detect_chip`` with and without a calibration for an unknown card's name
(monkeypatched).  The probe itself runs on the card (``chip_smoke.py``
phase 26c)."""

import json

import pytest
import torch

from gemm_hls_tpu.tools import calibrate as jcal
from gemm_hls_tpu_torch.models import perf_model
from gemm_hls_tpu_torch.tools import autotune, calibrate


@pytest.mark.parametrize("args", [(10e-3 + 16 * 2.2e-7, 16, 10e-3 + 512 * 2.2e-7, 512),
                                  (5e-3, 10, 4e-3, 20), (1.0, 1, 3.0, 3), (0.0, 0, 0.0, 1)])
def test_fit_latch_matches_jax(args):
    assert calibrate.fit_latch(*args) == jcal.fit_latch(*args)


def test_fit_latch_refuses_a_sparser_dense_probe():
    for mod in (calibrate, jcal):
        with pytest.raises(ValueError):
            mod.fit_latch(1.0, 20, 1.0, 10)


@pytest.fixture
def unknown_card(monkeypatch, tmp_path):
    """A card named "NVIDIA Foo 9000"; returns the calibration cache path."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA Foo 9000")
    path = tmp_path / "calibration.json"
    monkeypatch.setattr(calibrate, "CALIBRATION_CACHE", str(path))
    return path


def test_detect_chip_uses_the_calibration(unknown_card):
    unknown_card.write_text(json.dumps({"nvidia foo 9000": {
        "measured_bf16_flops": 494.5e12, "grid_step_overhead_s": 0.0, "timestamp": 0.0}}))
    spec = perf_model.detect_chip("cuda")
    h = perf_model.H100
    assert spec.name == "nvidia foo 9000" and spec.grid_step_overhead_s == 0.0
    # The H100's data-sheet roofline scaled by the measured engine rate.
    assert spec.peak_flops["bfloat16"] == pytest.approx(494.5e12)
    assert spec.peak_flops["int8"] == pytest.approx(h.peak_flops["int8"] / 2)
    assert spec.vpu_ops == pytest.approx(h.vpu_ops / 2)
    assert spec.hbm_bandwidth == h.hbm_bandwidth and spec.vmem_bytes == h.vmem_bytes
    assert calibrate.load_calibration("NVIDIA FOO 9000")["measured_bf16_flops"] == 494.5e12
    assert autotune._chip_name("cuda") == "nvidia foo 9000"


def test_detect_chip_without_a_calibration_names_the_tool(unknown_card):
    with pytest.raises(NotImplementedError, match="gemm_hls_tpu_torch.tools.calibrate"):
        perf_model.detect_chip("cuda")
    # The tuner's lookups miss on such a card; they never raise.
    assert autotune._chip_name("cuda") is None


def test_an_h100_needs_no_calibration(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(calibrate, "CALIBRATION_CACHE", str(tmp_path / "absent.json"))
    assert perf_model.detect_chip("cuda") is perf_model.H100
    assert perf_model.detect_chip("cpu") is perf_model.CPU
