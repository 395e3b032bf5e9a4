"""``python -m gemm_hls_tpu_torch``: capability summary and CLI index, the
port of ``gemm_hls_tpu/__main__.py``."""

import torch

from gemm_hls_tpu_torch import __version__, available_semirings
from gemm_hls_tpu_torch.models.perf_model import detect_chip
from gemm_hls_tpu_torch.utils.native import get_library
from gemm_hls_tpu_torch.utils.tileio import native_tileio_available

CLIS = [
    ("gemm_hls_tpu_torch.tools.run", "run one GEMM: timing, GOp/s, verification"),
    ("gemm_hls_tpu_torch.tools.sweep", "configuration sweeps with failure taxonomy -> CSV"),
    ("gemm_hls_tpu_torch.tools.autotune", "measure + cache the best route / plan for a problem"),
    ("gemm_hls_tpu_torch.tools.calibrate", "self-calibration of a card without constants"),
    ("gemm_hls_tpu_torch.tools.tile_optimizer", "shared-memory-budget tile optimizer"),
    ("gemm_hls_tpu_torch.tools.print_specifications", "analytical roofline expectations"),
    ("gemm_hls_tpu_torch.tools.profile", "measured vs roofline + torch.profiler trace"),
    ("gemm_hls_tpu_torch.tools.oversize", "out-of-device-memory host-staged GEMM"),
    ("gemm_hls_tpu_torch.tools.selftest", "the card battery (21 checks vs oracle)"),
    ("gemm_hls_tpu_torch.tools.flash_ab", "flash kernel variants timed in turns"),
    ("gemm_hls_tpu_torch.tools.w8a8_ab", "W8A8 kernel variants timed in turns"),
    ("gemm_hls_tpu_torch.tools.row_softmax_ab", "row-softmax kernel variants timed in turns"),
    ("gemm_hls_tpu_torch.tools.decode_ab", "two trees' decode steps timed in turns"),
]


def main():
    if torch.cuda.is_available():
        backend = (f"cuda ({torch.cuda.device_count()} device(s): "
                   f"{torch.cuda.get_device_name(0)})")
    else:
        backend = "cpu (no CUDA device: the plain versions)"
    print(f"gemm_hls_tpu_torch {__version__} — communication-avoiding semiring "
          f"GEMM on PyTorch and CUDA")
    print(f"backend: {backend}, chip model: {detect_chip().name}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"semirings: {', '.join(available_semirings())}")
    print(f"native oracle: {'available' if get_library() is not None else 'unavailable'}; "
          f"native tile IO: {'available' if native_tileio_available() else 'unavailable'}")
    print()
    print("CLIs:")
    for mod, desc in CLIS:
        print(f"  python -m {mod:51s} {desc}")
    print()
    print("docs: README.md (the port's section), PERF.md, ROADMAP.md")


if __name__ == "__main__":
    main()
