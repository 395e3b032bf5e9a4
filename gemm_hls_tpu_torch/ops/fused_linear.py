"""Trainable fused linear layer: y = act(x @ W + b) in one kernel pass.

Counterpart of ``gemm_hls_tpu/ops/fused_linear.py``: a thin specialisation
of the differentiable fused-epilogue matmul (``ops/matmul.py``).  The
forward fuses bias + activation into kernel B1's store (B2's for a batched
``x`` that does not flatten); the backward skips the accumulator-recompute
GEMM by passing the registry's output-form derivative as ``epilogue_bwd``:

    dacc = g * act'(y)                     (elementwise, from y)
    dx   = dacc @ W^T                      (B1, transpose_b)
    dW   = x^T @ dacc                      (B1, transpose_a)
    db   = sum_rows dacc

Activations are those whose derivative is recoverable from the output:
identity, relu, sigmoid, tanh (registry entries "bias", "bias_relu",
"bias_sigmoid", "bias_tanh" of ``ops/epilogue.py``).
"""

from __future__ import annotations

from typing import Optional

from gemm_hls_tpu_torch.config import GemmConfig
from gemm_hls_tpu_torch.ops.epilogue import get_epilogue

# activation name -> epilogue registry name
_ACTIVATIONS = {"identity": "bias", "relu": "bias_relu",
                "sigmoid": "bias_sigmoid", "tanh": "bias_tanh"}


def fused_linear(x, w, b, activation: str = "relu",
                 config: Optional[GemmConfig] = None):
    """y = activation(x @ w + b), epilogue fused into the kernel.

    Args:
      x: (M, K), or (..., M, K) batched over leading dims; w: (K, N);
      b: (N,).
      activation: one of "identity", "relu", "sigmoid", "tanh".
    Differentiable end to end.
    """
    from gemm_hls_tpu_torch.ops.matmul import matmul

    try:
        ep = get_epilogue(_ACTIVATIONS[activation])
    except KeyError:
        raise ValueError(
            f"activation must be one of {sorted(_ACTIVATIONS)}, "
            f"got {activation!r}") from None
    return matmul(x, w, config=config, epilogue=ep, epilogue_operands=(b,),
                  epilogue_bwd=ep.bwd)
