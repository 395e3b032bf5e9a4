"""Mixture-of-experts FFN on the grouped GEMM kernel (B16).

Counterpart of ``gemm_hls_tpu/models/moe.py``: a top-k-routed two-matmul
expert FFN

    y = sum_k  w_k(x) * W2[e_k(x)] @ act(W1[e_k(x)] @ x)

with a learned softmax router.  Tokens are sorted by expert id (a stable
sort over tokens x top_k slots), the per-expert row counts become
``group_sizes`` and one grouped-GEMM launch per matmul serves every
routing outcome.  Nothing on the path reads the routing on the host: the
sort, the counts (``scatter_add_``, not ``bincount``, which reads its
maximum back) and the kernel's group ends all stay on the card, so a
forward pass needs no host synchronisation.

Routing: the router product runs in fp32 (TF32 off on the card, as the
callers set it) and top-k takes the largest logits with the lower expert
index first on ties, as ``jax.lax.top_k`` does (a stable descending sort;
``torch.topk`` promises no tie order).  ``activation`` defaults to the
tanh GELU, ``jax.nn.gelu``'s default (torch's default is the erf form).

Training (``moe_train_step``) runs through ``grouped_matmul``'s autograd:
B16 for the activations' gradient, the weight-gradient kernel B17 for the
experts', and the routing's gradient (through the mix weights) in plain
torch; the backward needs no host synchronisation either.  The
expert-parallel forms (``moe_forward_ep``, ``moe_forward_ep_a2a``) belong
to the multi-GPU slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gemm_hls_tpu_torch.config import GemmConfig, torch_dtype
from gemm_hls_tpu_torch.models.mlp import _tensor
from gemm_hls_tpu_torch.ops.epilogue import gelu_tanh
from gemm_hls_tpu_torch.ops.grouped import grouped_matmul


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 256
    d_ff: int = 512
    num_experts: int = 8
    top_k: int = 2
    dtype: str = "float32"
    # Router softmax/top-k always run in f32.
    gemm: Optional[GemmConfig] = None

    def gemm_cfg(self):
        """Explicit GemmConfig for the grouped GEMMs, or None (the
        promoted input type out)."""
        return self.gemm


def init_moe_params(generator: torch.Generator, cfg: MoEConfig):
    """Router + per-expert (W1, W2), He init, expert dim leading, on the
    generator's device (the numbers differ from ``jax.random``'s)."""
    dt, dev = torch_dtype(cfg.dtype), generator.device
    scale1 = (2.0 / cfg.d_model) ** 0.5
    scale2 = (2.0 / cfg.d_ff) ** 0.5

    def normal(shape, dtype):
        return torch.randn(shape, generator=generator, dtype=dtype, device=dev)

    return {
        "router": normal((cfg.d_model, cfg.num_experts), torch.float32) * 0.02,
        "w1": normal((cfg.num_experts, cfg.d_model, cfg.d_ff), dt)
        * torch.tensor(scale1, dtype=dt, device=dev),
        "w2": normal((cfg.num_experts, cfg.d_ff, cfg.d_model), dt)
        * torch.tensor(scale2, dtype=dt, device=dev),
    }


def params_from_reference(params, device="cuda"):
    """The JAX package's ``{"router", "w1", "w2"}`` (jax or numpy arrays,
    bf16 included, each converted with ``np.asarray``) as the port's
    parameters, on ``device`` (the card unless the caller names another)."""
    return {name: _tensor(params[name], device) for name in ("router", "w1", "w2")}


def route(x, router_w, num_experts: int, top_k: int, *,
          return_probs: bool = False):
    """Top-k softmax routing: (expert_ids (tokens, top_k) int64, mix
    weights (tokens, top_k) f32), the mix the softmax over the selected
    logits; with ``return_probs`` also the full softmax (tokens, E)."""
    logits = x.float() @ router_w.float()
    top_logits, expert_ids = torch.sort(logits, dim=-1, descending=True,
                                        stable=True)
    top_logits, expert_ids = top_logits[:, :top_k], expert_ids[:, :top_k]
    mix = torch.softmax(top_logits, dim=-1)
    if return_probs:
        return expert_ids, mix, torch.softmax(logits, dim=-1)
    return expert_ids, mix


def _balance_from(probs, expert_ids, num_experts: int, top_k: int):
    """Switch aux loss from an existing routing pass (see ``route``)."""
    f = (_counts(expert_ids.reshape(-1), num_experts).float()
         / expert_ids.shape[0] / top_k)
    p = probs.mean(0)
    return num_experts * torch.sum(f * p)


def load_balance_loss(x, router_w, num_experts: int, top_k: int):
    """Switch-style auxiliary loss E * sum_e f_e P_e (f_e: fraction of
    slots routed to e, P_e: mean router probability), minimised (-> 1.0) by
    uniform routing.  Runs its own routing pass."""
    expert_ids, _, probs = route(x, router_w, num_experts, top_k,
                                 return_probs=True)
    return _balance_from(probs, expert_ids, num_experts, top_k)


def _counts(ids, num: int):
    """Rows per id, int32, on the card without a host read."""
    return torch.zeros(num, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids)).to(torch.int32)


def _inverse(order):
    """The inverse permutation of ``order``, by one scatter."""
    return torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))


def _dispatch(x, expert_ids, num_experts: int):
    """Sort (token, k) slots by expert id: (sorted slot features,
    group_sizes, inverse permutation)."""
    slots = expert_ids.reshape(-1)
    order = torch.argsort(slots, stable=True)
    top_k = expert_ids.shape[1]
    xs = torch.index_select(x, 0, order // top_k)
    return xs, _counts(slots, num_experts), _inverse(order)


def _dispatch_ids(x, ids, num: int):
    """Row-per-slot variant of ``_dispatch``: ``ids`` is (rows,) and each
    row of ``x`` is one slot."""
    order = torch.argsort(ids, stable=True)
    return torch.index_select(x, 0, order), _counts(ids, num), _inverse(order)


def _combine(ys, inv, mix, tokens: int, top_k: int):
    y = torch.index_select(ys, 0, inv).reshape(tokens, top_k, -1)
    return torch.sum(y * mix[..., None].to(y.dtype), dim=1)


def _local_expert_ffn(x, expert_ids, mix, w1_slab, w2_slab, lo, cfg,
                      activation):
    """Slots routed to experts in [lo, lo + slab) run the two grouped
    GEMMs on the local weight slab; slots routed elsewhere sort into group
    ``per``, the grouped kernel's zero tail, and contribute zero."""
    per = w1_slab.shape[0]
    ids = torch.where((expert_ids >= lo) & (expert_ids < lo + per),
                      expert_ids - lo, per)
    xs, group_sizes, inv = _dispatch(x, ids, per + 1)
    group_sizes = group_sizes[:per]
    gemm_cfg = cfg.gemm_cfg()
    h = grouped_matmul(xs, w1_slab, group_sizes, gemm_cfg)
    h = activation(h).to(w2_slab.dtype)
    ys = grouped_matmul(h, w2_slab, group_sizes, gemm_cfg)
    return _combine(ys, inv, mix, x.shape[0], cfg.top_k)


def moe_forward(params, x, cfg: MoEConfig, activation=gelu_tanh,
                local_experts=None, with_aux: bool = False):
    """Single-device (or per-shard) MoE FFN: (tokens, d_model) -> same.

    ``local_experts`` = (lo, hi) restricts compute to experts in [lo, hi):
    slots routed elsewhere contribute zero (an expert-parallel shard's
    view).  ``with_aux`` also returns the Switch load-balancing loss of
    this routing pass: (y, aux_loss).
    """
    if with_aux:
        expert_ids, mix, probs = route(x, params["router"], cfg.num_experts,
                                       cfg.top_k, return_probs=True)
        aux = _balance_from(probs, expert_ids, cfg.num_experts, cfg.top_k)
    else:
        expert_ids, mix = route(x, params["router"], cfg.num_experts,
                                cfg.top_k)
    w1, w2 = params["w1"], params["w2"]
    if local_experts is None:
        gemm_cfg = cfg.gemm_cfg()
        xs, group_sizes, inv = _dispatch(x, expert_ids, cfg.num_experts)
        h = grouped_matmul(xs, w1, group_sizes, gemm_cfg)
        h = activation(h).to(w2.dtype)
        ys = grouped_matmul(h, w2, group_sizes, gemm_cfg)
        y = _combine(ys, inv, mix, x.shape[0], cfg.top_k)
    else:
        lo, hi = local_experts
        y = _local_expert_ffn(x, expert_ids, mix, w1[lo:hi], w2[lo:hi], lo,
                              cfg, activation)
    y = y.to(x.dtype)
    return (y, aux) if with_aux else y


def moe_loss(params, batch, cfg: MoEConfig, aux_weight: float = 0.0):
    """Mean squared error of ``moe_forward`` (+ ``aux_weight`` times the
    Switch aux loss of the same routing pass)."""
    x, y = batch
    if aux_weight:
        out, aux = moe_forward(params, x, cfg, with_aux=True)
    else:
        out = moe_forward(params, x, cfg)
    mse = torch.mean((out.float() - y.float()) ** 2)
    if aux_weight:
        mse = mse + aux_weight * aux
    return mse


def moe_train_step(params, batch, cfg: MoEConfig, lr=1e-2,
                   aux_weight: float = 0.0):
    """One SGD step, ``(p - lr * g.float()).to(p.dtype)`` for every
    parameter; gradients through the kernels' autograd.  ``lr`` is a float
    or a 0-d tensor (on the card, it is never read on the host);
    ``aux_weight`` gates the Switch load-balancing loss.  Returns (new
    params, loss); the given params are left as they were."""
    leaves = {name: p.detach().requires_grad_() for name, p in params.items()}
    loss = moe_loss(leaves, batch, cfg, aux_weight)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        new = {name: (p - lr * g.float()).to(p.dtype)
               for (name, p), g in zip(leaves.items(), grads)}
    return new, loss.detach()


def moe_forward_ep(params, x, cfg: MoEConfig, mesh=None, **kw):
    """Expert-parallel MoE over a device mesh: multi-GPU."""
    raise NotImplementedError(
        "moe_forward_ep shards experts over several GPUs: ROADMAP A7 "
        "(multi-GPU, torch.distributed)")


def moe_forward_ep_a2a(params, x, cfg: MoEConfig, mesh=None, **kw):
    """Expert-parallel MoE with all_to_all dispatch: multi-GPU."""
    raise NotImplementedError(
        "moe_forward_ep_a2a shards experts over several GPUs: ROADMAP A7 "
        "(multi-GPU, torch.distributed)")
