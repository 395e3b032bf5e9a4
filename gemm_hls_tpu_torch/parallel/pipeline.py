"""Pipeline parallelism: a microbatched GPipe schedule over a mesh axis.

Counterpart of ``gemm_hls_tpu/parallel/pipeline.py``.  Each rank of the
``pp`` axis owns one stage of a stacked-stage model, the JAX package's
two-layer MLP block ``relu(h @ w1 + b1) @ w2 + b2`` on the port's GEMM
(kernel B1 on the card).  The schedule runs T = M + P - 1 steps: at step t
stage 0 takes microbatch t (while t < M), every rank holding a microbatch
applies its stage, the last stage retires microbatch t - (P - 1), and the
activations move one hop along the ring (``parallel/sharding.py::ppermute``,
tag ``"pipeline"``; the wrap-around link carries drained slots, as in
JAX), T - 1 hops in all: JAX's scan also rotates after the last step, a
hop nothing reads, which the port leaves out.  A rank in the fill or drain
bubble launches nothing and sends zeros, which no retired microbatch
reads.  The last stage's outputs are
replicated by a ``psum`` over the axis, JAX's way (tag ``"pipeline_out"``).

One process drives every rank.  The backward pass is autograd through the
schedule: the ``ppermute`` s' adjoint is the reverse permutation (tag
``"pipeline_bwd"``), so the cotangents run the mirrored pipeline, as JAX's
autodiff of its scan does.  ``remat`` recomputes each stage application in
the backward (``torch.utils.checkpoint``, GPipe's activation policy).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from gemm_hls_tpu_torch.config import GemmConfig, torch_dtype
from gemm_hls_tpu_torch.ops.matmul import matmul
from gemm_hls_tpu_torch.parallel.mesh import Mesh
from gemm_hls_tpu_torch.parallel.sharding import (
    P, Sharded, device_put, global_tensor, on_device, ppermute, psum, rank_array,
)

_NAMES = ("w1", "b1", "w2", "b2")


def init_pipeline_params(generator: torch.Generator, n_stages: int, d_model: int,
                         d_ffn: int, dtype=torch.float32):
    """He-initialised stacked stage params on the generator's device, each
    leaf with a leading stage axis (the numbers differ from
    ``jax.random``'s)."""
    dt, dev = torch_dtype(dtype), generator.device

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=dt, device=dev)
        return w * torch.tensor((2.0 / fan_in) ** 0.5, dtype=dt, device=dev)

    return {"w1": normal((n_stages, d_model, d_ffn), d_model),
            "b1": torch.zeros((n_stages, d_ffn), dtype=dt, device=dev),
            "w2": normal((n_stages, d_ffn, d_model), d_ffn),
            "b2": torch.zeros((n_stages, d_model), dtype=dt, device=dev)}


def params_from_reference(params, device="cuda"):
    """The JAX package's stacked ``{"w1", "b1", "w2", "b2"}`` (jax or numpy
    arrays, each converted with ``np.asarray``) as the port's tensors on
    ``device`` (the card unless the caller names another)."""
    from gemm_hls_tpu_torch.models.mlp import _tensor
    return {name: _tensor(params[name], device) for name in _NAMES}


def shard_pipeline_params(params, mesh: Mesh, pp_axis: str = "pp"):
    """Each stage's slice on its rank of ``pp_axis``."""
    return {name: device_put(x, mesh, P(pp_axis, *([None] * (len(x.shape) - 1))))
            for name, x in params.items()}


def _stage_fn(w1, b1, w2, b2, h, config):
    """One stage: relu(h @ w1 + b1) @ w2 + b2 on the port's GEMM."""
    h = torch.relu(matmul(h, w1, config=config) + b1)
    return matmul(h, w2, config=config) + b2


def stages_forward(params, x, *, config: Optional[GemmConfig] = None):
    """Unpipelined oracle: every stage in order on x's device."""
    params = {name: global_tensor(p) for name, p in params.items()}
    h = x
    for i in range(params["w1"].shape[0]):
        h = _stage_fn(*(params[name][i] for name in _NAMES), h, config)
    return h


def pipeline_forward(params, x, mesh: Mesh, *, microbatches: int, pp_axis: str = "pp",
                     config: Optional[GemmConfig] = None, remat: bool = True) -> Sharded:
    """GPipe-scheduled forward of the stacked-stage model.

    Args:
      params: stacked stage params (:func:`init_pipeline_params`), tensors
        or :func:`shard_pipeline_params`' layout (leading stage axis over
        ``pp_axis``).
      x: (B, d_model) global batch, B a multiple of ``microbatches``; its
        microbatches are read on stage 0's rank only.
      microbatches: M; the bubble fraction is (P - 1) / (M + P - 1).
      remat: recompute each stage application in the backward.

    Returns a :class:`Sharded` (B, d_model), replicated over the mesh.
    Differentiable: autograd through it runs the mirrored pipeline.
    """
    n_stages = mesh.shape[pp_axis]
    x = global_tensor(x)
    bsz, d_model = x.shape
    if bsz % microbatches:
        raise ValueError(f"batch {bsz} % microbatches {microbatches} != 0")
    if params["w1"].shape[0] != n_stages:
        raise ValueError(f"params carry {params['w1'].shape[0]} stages but mesh axis "
                         f"'{pp_axis}' has {n_stages} devices")
    params = shard_pipeline_params(params, mesh, pp_axis)
    mb = bsz // microbatches
    coords = mesh.coords()
    stage = {c: mesh.axis_index(c, pp_axis) for c in coords}
    first = [c for c in coords if stage[c] == 0]
    x_mb = {c: x.reshape(microbatches, mb, d_model).to(mesh.devices[c]) for c in first}
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def apply(c, h):
        args = [params[name].shard(c)[0] for name in _NAMES] + [h]
        if remat:
            return checkpoint(_stage_fn, *args, config, use_reentrant=False)
        return _stage_fn(*args, config)

    state = rank_array(mesh)
    outs = {c: [None] * microbatches for c in coords}
    steps = microbatches + n_stages - 1
    for t in range(steps):
        h = rank_array(mesh)
        for c in coords:
            m = t - stage[c]  # the microbatch this rank holds at step t
            with on_device(mesh.devices[c]):
                if 0 <= m < microbatches:
                    h[c] = apply(c, x_mb[c][t] if stage[c] == 0 else state[c])
                    if stage[c] == n_stages - 1:
                        outs[c][m] = h[c]
                else:  # bubble: nothing to compute, zeros to send
                    h[c] = torch.zeros((mb, d_model), dtype=x.dtype, device=mesh.devices[c])
        if t + 1 < steps:  # the last step's hop would carry nothing that is read
            state = ppermute(h, mesh, pp_axis, perm, tag="pipeline")
    # Only the last stage holds real outputs; a psum replicates them.
    full = rank_array(mesh)
    for c in coords:
        with on_device(mesh.devices[c]):
            full[c] = (torch.cat(outs[c], 0) if stage[c] == n_stages - 1 else
                       torch.zeros((bsz, d_model), dtype=x.dtype, device=mesh.devices[c]))
    return Sharded(mesh, P(None, None), (bsz, d_model),
                   psum(full, mesh, pp_axis, tag="pipeline_out"))


def pipeline_loss(params, batch, mesh: Mesh, *, microbatches: int, pp_axis: str = "pp",
                  config: Optional[GemmConfig] = None):
    """Mean squared error of :func:`pipeline_forward`, in fp32."""
    x, y = batch
    pred = pipeline_forward(params, x, mesh, microbatches=microbatches, pp_axis=pp_axis,
                            config=config).full()
    return torch.mean((pred.float() - y.to(pred.device).float()) ** 2)


def pipeline_train_step(params, batch, mesh: Mesh, *, microbatches: int,
                        pp_axis: str = "pp", config: Optional[GemmConfig] = None, lr=1e-3):
    """One SGD step through the pipelined forward and backward: (new params
    in :func:`shard_pipeline_params`' layout, loss); every stage's shard is
    updated on its own rank."""
    placed = shard_pipeline_params(params, mesh, pp_axis)
    leaves = {}
    for name, p in placed.items():
        shards = rank_array(mesh)
        for c in mesh.coords():
            shards[c] = p.shard(c).detach().requires_grad_()
        leaves[name] = Sharded(mesh, p.spec, p.shape, shards)
    loss = pipeline_loss(leaves, batch, mesh, microbatches=microbatches, pp_axis=pp_axis,
                         config=config)
    flat = [leaves[name].shard(c) for name in leaves for c in mesh.coords()]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    new = {}
    with torch.no_grad():
        for name, p in leaves.items():
            shards = rank_array(mesh)
            for c in mesh.coords():
                g = next(grads)
                shards[c] = p.shard(c).detach() - (0 if g is None else lr * g)
            new[name] = Sharded(mesh, p.spec, p.shape, shards)
    return new, loss.detach()
