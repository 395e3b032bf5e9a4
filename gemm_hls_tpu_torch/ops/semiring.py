"""Configurable (map, reduce) semiring registry, in PyTorch.

Counterpart of ``gemm_hls_tpu/ops/semiring.py``: the same names, identities
and absorbing pairs, torch ops for ``map_op``/``reduce_op``, and the same
numpy oracles (copied, since importing the JAX package pulls in jax).

C[i,j] = reduce_k map(A[i,k], B[k,j]).  Only ``plus_times`` (and bool
``or_and``, by exact int8 counting) rides the tensor cores; every other
semiring runs on the CUDA-core kernel B3 (``csrc/semiring_gemm.cu`` and its
per-type sources), which implements each built-in as a functor selected by
``op_code``.  A user semiring (``op_code`` None) runs B3's tile too: its
``map_op`` and ``reduce_op`` are traced and compiled at first use into a
functor of its own (``ops/codegen.py``), with ``identity_for`` as its
identity; one whose ops the functor cannot express raises
NotImplementedError on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gemm_hls_tpu_torch.config import torch_dtype


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (map, reduce) operator pair with reduce identity.

    Attributes:
      name: registry key.
      map_op / reduce_op: broadcasting torch binary ops.
      identity: reduce identity as a Python scalar.
      np_map / np_reduce: numpy oracle ops; ``np_reduce`` is a ufunc.
      is_mxu: True only for the arithmetic (+, x) semiring.
      reduce_axis: ``f(x, dim)`` axis reduction matching ``reduce_op``
        (None: balanced fold of ``reduce_op``).
      absorbing: (pad_a, pad_b) with ``map(pad_a, pad_b) == identity``.
      op_code: functor index in ``csrc/semiring_gemm.cu`` (None: a
        generated functor, ``ops/codegen.py``).
    """

    name: str
    map_op: Callable
    reduce_op: Callable
    identity: object
    np_map: Callable
    np_reduce: np.ufunc
    is_mxu: bool = False
    reduce_axis: Optional[Callable] = None
    absorbing: Optional[tuple] = None
    op_code: Optional[int] = None

    def reduce_along(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.reduce_axis is not None:
            return self.reduce_axis(x, dim)
        return fold_axis(x, self.reduce_op, dim)

    def identity_for(self, dtype):
        """Reduce identity cast to ``dtype`` (inf -> the integer extremes)."""
        d = torch_dtype(dtype)
        v = self.identity
        if d == torch.bool:
            return bool(v)
        if not d.is_floating_point:
            if isinstance(v, float) and np.isinf(v):
                info = torch.iinfo(d)
                return info.max if v > 0 else info.min
            return int(v)
        return float(v)

    def supports_dtype(self, dtype) -> bool:
        if torch_dtype(dtype) == torch.bool:
            return self.name in ("or_and",)
        return True

    def absorbing_for(self, dtype):
        """The K-padding pair cast to ``dtype``; infinite pads under an
        additive map become half the integer extreme so ``map(pad, pad)``
        cannot wrap (see the JAX counterpart)."""
        if self.absorbing is None:
            return None
        d = torch_dtype(dtype)
        additive_map = self.np_map is np.add

        def cast(v):
            if d == torch.bool:
                return bool(v)
            if not d.is_floating_point:
                if isinstance(v, float) and np.isinf(v):
                    info = torch.iinfo(d)
                    ext = info.max if v > 0 else info.min
                    return ext // 2 if additive_map else ext
                return int(v)
            return float(v)

        return cast(self.absorbing[0]), cast(self.absorbing[1])


def fold_axis(x: torch.Tensor, op: Callable, dim: int) -> torch.Tensor:
    """Fold ``x`` along ``dim`` with a balanced tree of binary ``op``."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        half = n // 2
        folded = op(x.narrow(dim, 0, half), x.narrow(dim, half, half))
        if n % 2:
            folded = torch.cat([folded, x.narrow(dim, 2 * half, 1)], dim=dim)
        x = folded
    return x.squeeze(dim)


_REGISTRY: Dict[str, Semiring] = {}


def register_semiring(sr: Semiring, overwrite: bool = False) -> Semiring:
    if sr.name in _REGISTRY and not overwrite:
        raise ValueError(f"semiring {sr.name!r} already registered")
    _REGISTRY[sr.name] = sr
    return sr


def get_semiring(sr) -> Semiring:
    """Resolve a name or pass through a Semiring instance."""
    if isinstance(sr, Semiring):
        return sr
    try:
        return _REGISTRY[sr]
    except KeyError:
        raise KeyError(
            f"unknown semiring {sr!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_semirings():
    return sorted(_REGISTRY)


def _amin(x, dim):
    return torch.amin(x, dim=dim)


def _amax(x, dim):
    return torch.amax(x, dim=dim)


def _sum(x, dim):
    return torch.sum(x, dim=dim, dtype=x.dtype)


def _any(x, dim):
    return torch.any(x, dim=dim)


# ---- built-ins; op codes match ``enum Op`` in csrc/semiring_gemm.cu -------

register_semiring(Semiring(
    name="plus_times", map_op=torch.mul, reduce_op=torch.add, identity=0,
    np_map=np.multiply, np_reduce=np.add, reduce_axis=_sum, is_mxu=True,
    absorbing=(0, 0), op_code=0,
))

register_semiring(Semiring(
    name="min_plus", map_op=torch.add, reduce_op=torch.minimum,
    identity=float("inf"), np_map=np.add, np_reduce=np.minimum,
    reduce_axis=_amin, absorbing=(float("inf"), float("inf")), op_code=1,
))

register_semiring(Semiring(
    name="max_plus", map_op=torch.add, reduce_op=torch.maximum,
    identity=float("-inf"), np_map=np.add, np_reduce=np.maximum,
    reduce_axis=_amax, absorbing=(float("-inf"), float("-inf")), op_code=2,
))

register_semiring(Semiring(
    name="max_min", map_op=torch.minimum, reduce_op=torch.maximum,
    identity=float("-inf"), np_map=np.minimum, np_reduce=np.maximum,
    reduce_axis=_amax, absorbing=(float("-inf"), float("-inf")), op_code=3,
))

register_semiring(Semiring(
    name="min_max", map_op=torch.maximum, reduce_op=torch.minimum,
    identity=float("inf"), np_map=np.maximum, np_reduce=np.minimum,
    reduce_axis=_amin, absorbing=(float("inf"), float("inf")), op_code=4,
))

register_semiring(Semiring(
    name="max_times", map_op=torch.mul, reduce_op=torch.maximum,
    identity=float("-inf"), np_map=np.multiply, np_reduce=np.maximum,
    reduce_axis=_amax, op_code=5,
))

register_semiring(Semiring(
    # Bool reachability: tensor cores by int8 counting (ops/matmul.py), or
    # bit-packed on the CUDA-core kernel (``or_and_bits``, op code 9).
    name="or_and", map_op=torch.logical_and, reduce_op=torch.logical_or,
    identity=False, np_map=np.logical_and, np_reduce=np.logical_or,
    reduce_axis=_any, absorbing=(False, False),
))


def _absdiff(x, y):
    return torch.abs(x - y)


def _np_absdiff(x, y):
    return np.abs(x - y)


def _sqdiff(x, y):
    d = x - y
    return d * d


def _np_sqdiff(x, y):
    d = x - y
    return d * d


register_semiring(Semiring(
    # Pairwise L1 distances: C[i,j] = sum_k |A[i,k] - B[k,j]|.
    name="plus_absdiff", map_op=_absdiff, reduce_op=torch.add, identity=0,
    np_map=_np_absdiff, np_reduce=np.add, reduce_axis=_sum,
    absorbing=(0, 0), op_code=6,
))

register_semiring(Semiring(
    # Pairwise squared-L2 distances: C[i,j] = sum_k (A[i,k] - B[k,j])^2.
    name="plus_sqdiff", map_op=_sqdiff, reduce_op=torch.add, identity=0,
    np_map=_np_sqdiff, np_reduce=np.add, reduce_axis=_sum,
    absorbing=(0, 0), op_code=7,
))

register_semiring(Semiring(
    # Log semiring: the stable sum-product in log space.  logaddexp(-inf,
    # -inf) is -inf in torch, numpy and the kernel alike.
    name="log_plus", map_op=torch.add, reduce_op=torch.logaddexp,
    identity=float("-inf"), np_map=np.add, np_reduce=np.logaddexp,
    absorbing=(float("-inf"), float("-inf")), op_code=8,
))
