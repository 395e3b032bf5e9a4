"""The repo's training application: an MLP whose every matmul is the
port's GEMM, trained with plain SGD through the kernels' autograd.

Counterpart of ``gemm_hls_tpu/models/mlp.py`` (and of
``examples/06_training.py``).  Parameters are ``[(W (din, dout), b
(dout,)), ...]``, the JAX package's layout; :class:`MLP` holds the same
pairs as ``nn.Parameter`` s.  ``fused=True`` runs every layer as
``fused_linear`` (bias and activation in kernel B1's store, and the
output-form backward); ``fused=False`` runs ``matmul`` then a separate
bias add and relu.  The JAX package's dp/tp sharding helpers
(``param_shardings``, ``shard_params``, ``batch_sharding``) belong to the
multi-GPU slice of the port and are not here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gemm_hls_tpu_torch.config import GemmConfig
from gemm_hls_tpu_torch.ops.fused_linear import fused_linear
from gemm_hls_tpu_torch.ops.matmul import matmul

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def init_params(generator: torch.Generator, dims: Sequence[int],
                dtype=torch.float32) -> Params:
    """He-initialised (W, b) per layer, on the generator's device."""
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = torch.randn((din, dout), generator=generator, dtype=dtype,
                        device=generator.device)
        w = w * torch.tensor((2.0 / din) ** 0.5, dtype=dtype,
                             device=generator.device)
        params.append((w, torch.zeros(dout, dtype=dtype,
                                      device=generator.device)))
    return params


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":  # numpy has no bf16: reinterpret its bits
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x.copy()).to(device)


def params_from_reference(params, device="cuda") -> Params:
    """The JAX package's ``[(W, b), ...]`` (jax or numpy arrays, each
    converted with ``np.asarray``) as the port's parameters, on ``device``
    (the card unless the caller names another)."""
    return [(_tensor(w, device), _tensor(b, device)) for w, b in params]


def mlp_forward(params: Params, x, *, config: Optional[GemmConfig] = None,
                fused: bool = False):
    """Forward pass; every layer matmul is the port's GEMM."""
    h = x
    for i, (w, b) in enumerate(params):
        last = i + 1 == len(params)
        if fused:
            h = fused_linear(h, w, b, "identity" if last else "relu", config)
        else:
            h = matmul(h, w, config=config) + b
            if not last:
                h = torch.relu(h)
    return h


def loss_fn(params: Params, batch, *, config: Optional[GemmConfig] = None,
            fused: bool = False):
    x, y = batch
    pred = mlp_forward(params, x, config=config, fused=fused)
    return torch.mean((pred - y) ** 2)


def train_step(params: Params, batch, *, config: Optional[GemmConfig] = None,
               lr=1e-3, fused: bool = False):
    """One SGD step; gradients flow through the kernels' autograd.  Returns
    (new params, loss); the given params are left as they were."""
    leaves = [t.detach().requires_grad_() for wb in params for t in wb]
    pairs = list(zip(leaves[::2], leaves[1::2]))
    loss = loss_fn(pairs, batch, config=config, fused=fused)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(leaves, grads)]
    return list(zip(new[::2], new[1::2])), loss.detach()


def make_batch(generator: torch.Generator, batch_size: int, din: int,
               dout: int, dtype=torch.float32):
    """Standard-normal (x, y) on the generator's device."""
    x = torch.randn((batch_size, din), generator=generator, dtype=dtype,
                    device=generator.device)
    y = torch.randn((batch_size, dout), generator=generator, dtype=dtype,
                    device=generator.device)
    return x, y


class MLP(torch.nn.Module):
    """The same (W (din, dout), b) pairs as ``nn.Parameter`` s."""

    def __init__(self, params: Params, *, config: Optional[GemmConfig] = None,
                 fused: bool = False):
        super().__init__()
        self.weights = torch.nn.ParameterList(
            torch.nn.Parameter(w) for w, _ in params)
        self.biases = torch.nn.ParameterList(
            torch.nn.Parameter(b) for _, b in params)
        self.config = config
        self.fused = fused

    def params(self) -> Params:
        return list(zip(self.weights, self.biases))

    def forward(self, x):
        return mlp_forward(self.params(), x, config=self.config,
                           fused=self.fused)
