"""The repo's training application: an MLP whose every matmul is the
port's GEMM, trained with plain SGD through the kernels' autograd.

Counterpart of ``gemm_hls_tpu/models/mlp.py`` (and of
``examples/06_training.py``).  Parameters are ``[(W (din, dout), b
(dout,)), ...]``, the JAX package's layout; :class:`MLP` holds the same
pairs as ``nn.Parameter`` s.  ``fused=True`` runs every layer as
``fused_linear`` (bias and activation in kernel B1's store, and the
output-form backward); ``fused=False`` runs ``matmul`` then a separate
bias add and relu.

Data and tensor parallelism over a (dp, tp) mesh of ranks, the JAX
package's Megatron-style layout: the batch split over dp, layer 2i's
weight (din, dhid) split by columns over tp (its bias too), layer 2i+1's
(dhid, dout) by rows (its bias replicated).  ``param_shardings``,
``shard_params`` and ``batch_sharding`` give and apply that layout;
``train_step`` on :class:`~gemm_hls_tpu_torch.parallel.sharding.Sharded`
params runs the step on every rank at once (one process drives them all,
``parallel/sharding.py``): a column-parallel layer, then a row-parallel one
whose partial products meet in a tp ``psum``; each dp group's loss on its
first tp rank; autograd through the collectives; every gradient summed
over the axes its parameter is replicated on (dp for the weights, dp and
tp for a row layer's bias); the unsharded step's SGD update on every
shard.  JAX leaves the same reductions to GSPMD.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gemm_hls_tpu_torch.config import GemmConfig
from gemm_hls_tpu_torch.ops.fused_linear import fused_linear
from gemm_hls_tpu_torch.ops.matmul import matmul
from gemm_hls_tpu_torch.parallel.mesh import _axes
from gemm_hls_tpu_torch.parallel.sharding import (
    P, Sharded, all_gather, device_put, on_device, psum, rank_array,
)

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


def param_shardings(mesh, n_layers: int, dp: str = "dp", tp: str = "tp"):
    """Alternating column / row tensor-parallel layouts, one (weight spec,
    bias spec) pair a layer (JAX's ``NamedSharding`` s over ``mesh``, here
    their specs)."""
    del mesh, dp
    return [(P(None, tp), P(tp)) if i % 2 == 0 else (P(tp, None), P(None))
            for i in range(n_layers)]


def shard_params(params: Params, mesh, dp: str = "dp", tp: str = "tp"):
    """``params`` laid out over ``mesh`` by :func:`param_shardings`."""
    return [(device_put(w, mesh, sw), device_put(b, mesh, sb))
            for (w, b), (sw, sb) in zip(params, param_shardings(mesh, len(params), dp, tp))]


def batch_sharding(mesh, dp: str = "dp"):
    """The batch's layout: rows split over ``dp``."""
    del mesh
    return P(dp, None)


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


def _replicated_axes(mesh, spec):
    """The mesh axes ``spec`` does not split: a gradient is summed over them."""
    named = {a for entry in spec if entry is not None for a in _axes(entry)}
    return tuple(a for a in mesh.axis_names if a not in named)


def _sharded_step(params, batch, config, lr, fused):
    """:func:`train_step` on :class:`Sharded` params (see the module
    docstring); the mesh's axes are read from the params' specs."""
    mesh = params[0][0].mesh
    tp = params[0][0].spec[1]
    if isinstance(batch[0], Sharded):
        spec = batch[0].spec
    else:
        spec = P(next((a for a in mesh.axis_names if a != tp), None), None)
    x, y = (device_put(t, mesh, spec) for t in batch)
    count = y.shape[0] * y.shape[1]
    leaves = [[rank_array(mesh) for _ in wb] for wb in params]
    for layer, wb in zip(leaves, params):
        for arr, p in zip(layer, wb):
            for c in mesh.coords():
                arr[c] = p.shard(c).detach().requires_grad_()
    h = x.shards
    for i, (w, b) in enumerate(leaves):
        last = i + 1 == len(leaves)
        out = rank_array(mesh)
        if i % 2 == 0:  # column parallel: h is replicated over tp
            for c in mesh.coords():
                with on_device(mesh.devices[c]):
                    if fused:
                        out[c] = fused_linear(h[c], w[c], b[c], "identity" if last else "relu",
                                              config)
                    else:
                        out[c] = matmul(h[c], w[c], config=config) + b[c]
                        out[c] = out[c] if last else torch.relu(out[c])
            h = all_gather(out, mesh, tp, dim=1, tag="tp_all_gather") if last else out
            continue
        for c in mesh.coords():  # row parallel: partial products, then the tp psum
            with on_device(mesh.devices[c]):
                out[c] = matmul(h[c], w[c], config=config)
        h = psum(out, mesh, tp, tag="tp_psum")
        for c in mesh.coords():
            with on_device(mesh.devices[c]):
                h[c] = h[c] + b[c]
                h[c] = h[c] if last else torch.relu(h[c])
    # Each dp group's loss once, on its first tp rank.
    first = [c for c in mesh.coords() if mesh.axis_index(c, tp) == 0]
    local = rank_array(mesh)
    for c in mesh.coords():
        with on_device(mesh.devices[c]):
            local[c] = (torch.sum((h[c] - y.shard(c)) ** 2) / count if c in first
                        else torch.zeros((), dtype=h[c].dtype, device=h[c].device))
    flat = [t for layer in leaves for arr in layer for t in arr.flat]
    grads = torch.autograd.grad([local[c] for c in first], flat, allow_unused=True)
    with torch.no_grad():
        for c in mesh.coords():
            local[c] = local[c].detach()
        loss = psum(local, mesh, mesh.axis_names, tag="loss")
        new, it = [], iter(grads)
        for layer, wb in zip(leaves, params):
            pair = []
            for arr, p in zip(layer, wb):
                g = rank_array(mesh)
                for c in mesh.coords():
                    gc = next(it)
                    g[c] = torch.zeros_like(arr[c]) if gc is None else gc
                axes = _replicated_axes(mesh, p.spec)
                if axes:
                    g = psum(g, mesh, axes, tag="grad_psum")
                shards = rank_array(mesh)
                for c in mesh.coords():
                    with on_device(mesh.devices[c]):
                        shards[c] = arr[c].detach() - lr * g[c]
                pair.append(Sharded(mesh, p.spec, p.shape, shards))
            new.append(tuple(pair))
    return new, loss.flat[0]


def train_step(params: Params, batch, *, config: Optional[GemmConfig] = None,
               lr=1e-3, fused: bool = False):
    """One SGD step; gradients flow through the kernels' autograd.  Returns
    (new params, loss); the given params are left as they were.

    On :class:`Sharded` params (:func:`shard_params`) the step runs on
    their (dp, tp) mesh (the batch, tensors or :class:`Sharded`, laid out
    by :func:`batch_sharding`) and returns params of the same layout; the
    collectives' bytes count in ``parallel.sharding.BYTES`` under
    ``"tp_psum"`` (forward), ``"tp_psum_bwd"``, ``"grad_psum"`` and
    ``"loss"``."""
    if isinstance(params[0][0], Sharded):
        return _sharded_step(params, batch, config, lr, fused)
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
