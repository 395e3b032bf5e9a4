"""Named fused epilogues: what kernels B1 and B2 apply to the accumulator
before the output cast, in PyTorch idiom.

Counterpart of the ``epilogue=`` callables of the JAX package
(``gemm_hls_tpu/ops/matmul.py::matmul``, ``ops/fused_linear.py``,
``ops/attention.py::_softmax_rows``).  A Pallas kernel traces any Python
function into its store; a CUDA kernel runs only what was compiled into it.
So an epilogue here is a registry entry that holds

* ``fn(acc, *operands)``: the torch function; the plain version applies it,
  and autograd differentiates it when no output-form derivative is given;
* ``code``: the kernel's epilogue (``EpKind`` in ``csrc/common.cuh``),
  or None where the kernels have no per-element code for it;
* ``bwd(y, g, *operands) -> (dacc, *doperands)``: the output-form
  derivative that ``fused_linear`` passes as ``epilogue_bwd``, or None;
* ``rows``: it needs whole rows (the row softmax), so it runs on kernel
  B2's row-softmax variant (``csrc/row_softmax_wgmma.cu`` or
  ``csrc/row_softmax.cu``), never on a tile that splits a row.

Operands are per-output-column: (N,) tensors, seen by ``fn`` and ``bwd`` as
(1, N).  ``matmul(epilogue=...)`` takes a registry name, an entry, or any
callable; a callable runs on CPU tensors only (see :func:`kernel_code`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Epilogue:
    name: str
    fn: Callable
    code: Optional[int] = None
    n_operands: int = 0
    bwd: Optional[Callable] = None
    rows: bool = False


def _output_form_bwd(dact):
    """``(y, g, bias2d) -> (dacc, dbias2d)`` from an activation derivative
    written in terms of the output y (``fused_linear.py:35-45`` of the JAX
    package).  dacc is fp32, the type the backward GEMMs contract over;
    dbias sums every leading axis, so one function serves B1 and B2."""
    def bwd(y, g, bias2d):
        dacc = g.float() * dact(y.float())
        return dacc, dacc.reshape(-1, dacc.shape[-1]).sum(0, keepdim=True)
    return bwd


def gelu_tanh(x):
    """``jax.nn.gelu``'s default (approximate=True) form, the tanh GELU
    (torch's default is the erf form).  The ``bias_gelu`` epilogue and the
    MoE FFN's activation (``models/moe.py``)."""
    return F.gelu(x, approximate="tanh")


def softmax_rows(acc):
    """Row softmax over the last axis of the fp32 accumulator
    (``gemm_hls_tpu/ops/attention.py::_softmax_rows``)."""
    e = torch.exp(acc - acc.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


_REGISTRY = {e.name: e for e in (
    Epilogue("bias", lambda acc, b: acc + b, code=1, n_operands=1,
             bwd=_output_form_bwd(torch.ones_like)),
    Epilogue("bias_relu", lambda acc, b: torch.relu(acc + b), code=2,
             n_operands=1,
             bwd=_output_form_bwd(lambda y: (y > 0).to(y.dtype))),
    Epilogue("bias_sigmoid", lambda acc, b: torch.sigmoid(acc + b), code=3,
             n_operands=1, bwd=_output_form_bwd(lambda y: y * (1.0 - y))),
    Epilogue("bias_tanh", lambda acc, b: torch.tanh(acc + b), code=4,
             n_operands=1, bwd=_output_form_bwd(lambda y: 1.0 - y * y)),
    Epilogue("col_scale", lambda acc, s: acc * s, code=5, n_operands=1),
    Epilogue("scale_bias", lambda acc, s, b: acc * s + b, code=6,
             n_operands=2),
    Epilogue("bias_gelu", lambda acc, b: gelu_tanh(acc + b), code=7,
             n_operands=1),
    Epilogue("softmax", softmax_rows, rows=True),
)}


def available_epilogues():
    return sorted(_REGISTRY)


def get_epilogue(epilogue) -> Epilogue:
    """The entry for a registry name or entry; a bare callable becomes an
    entry with no kernel code."""
    if isinstance(epilogue, Epilogue):
        return epilogue
    if isinstance(epilogue, str):
        try:
            return _REGISTRY[epilogue]
        except KeyError:
            raise ValueError(f"unknown epilogue {epilogue!r}; registered: "
                             f"{available_epilogues()}") from None
    if callable(epilogue):
        return Epilogue(getattr(epilogue, "__name__", "callable"), epilogue)
    raise TypeError(f"epilogue must be a name, an Epilogue or a callable, "
                    f"got {type(epilogue).__name__}")


def kernel_code(ep: Epilogue) -> int:
    """The kernel's ``EpKind`` of ``ep``; raises for a callable, which no
    compiled kernel can run (a card never silently runs it unfused)."""
    if ep.code is None and not ep.rows:
        raise NotImplementedError(
            f"epilogue {ep.name!r} is a Python callable, which the CUDA "
            f"kernels cannot run; pass a registered epilogue "
            f"({', '.join(available_epilogues())}) or CPU tensors (ROADMAP B"
            f" coverage item 5: callable epilogues -> generated functor)")
    return ep.code or 0
