"""Configurable semirings: built-ins and user registration.

The port of ``examples/02_semirings.py`` to ``gemm_hls_tpu_torch``: the
same operands, calls, printed lines and checks.  On the card the built-in
semirings run kernel B3 (``csrc/semiring_gemm.cu``) and the bool or_and the
int8 route of B1; the custom ``plus_max`` runs B3 too, its map and reduce
compiled at first use into a functor of its own (``ops/codegen.py``, a few
seconds of nvcc, then cached under ``gemm_hls_tpu_torch/build/``).
``--device cpu`` runs their plain versions.

    python examples/torch/02_semirings.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from gemm_hls_tpu_torch import Semiring, available_semirings, matmul, register_semiring
from gemm_hls_tpu_torch.utils import make_operands, reference_matmul, verify_matmul


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    def on(x):
        return torch.from_numpy(x).to(dev)

    print("built-in semirings:", ", ".join(available_semirings()))

    a, b = make_operands(64, 96, 80, "float32")

    # Distance product (min, +): one APSP relaxation step.
    d = matmul(on(a), on(b), semiring="min_plus")
    verify_matmul(d.cpu().numpy(), reference_matmul(a, b, semiring="min_plus"))
    print("min_plus (distance product): verified")

    # Bottleneck paths (max, min).
    w = matmul(on(a), on(b), semiring="max_min")
    verify_matmul(w.cpu().numpy(), reference_matmul(a, b, semiring="max_min"))
    print("max_min (widest path): verified")

    # Boolean reachability (or, and) on a bool adjacency matrix.
    ab, bb = make_operands(32, 32, 32, "bool")
    r = matmul(on(ab), on(bb), semiring="or_and")
    np.testing.assert_array_equal(
        r.cpu().numpy(), reference_matmul(ab, bb, semiring="or_and"))
    print("or_and (reachability): verified")

    # User-defined semiring: plus_max ("longest concatenation").
    plus_max = register_semiring(Semiring(
        name="plus_max", map_op=torch.maximum, reduce_op=torch.add, identity=0,
        np_map=np.maximum, np_reduce=np.add,
        reduce_axis=lambda x, dim: torch.sum(x, dim=dim),
    ), overwrite=True)
    out = matmul(on(a), on(b), semiring=plus_max)
    verify_matmul(out.cpu().numpy(), reference_matmul(a, b, semiring="plus_max"))
    print("custom plus_max: registered and verified")


if __name__ == "__main__":
    main()
