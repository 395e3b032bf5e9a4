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
torch; the backward needs no host synchronisation either.

Expert parallelism over a mesh of ranks (one process drives them all,
``parallel/sharding.py``): ``moe_forward_ep`` splits the experts over an
``ep`` axis and (optionally) the tokens over ``dp``; every rank routes its
tokens, runs its local experts (slots routed elsewhere fall into B16's
zero tail) and a ``psum`` over ``ep`` merges the disjoint contributions.
``moe_forward_ep_a2a`` splits tokens and experts over the same axis and
moves only the routed slots: a fixed-capacity buffer per destination rank,
one ``all_to_all`` there and one back, slots past the capacity dropped
(exactly zero).  Both are differentiable through ``grouped_matmul``'s
autograd and the collectives' (their backward the adjoint copies).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gemm_hls_tpu_torch.config import GemmConfig, torch_dtype
from gemm_hls_tpu_torch.models.mlp import _tensor
from gemm_hls_tpu_torch.ops.epilogue import gelu_tanh
from gemm_hls_tpu_torch.ops.grouped import grouped_matmul
from gemm_hls_tpu_torch.parallel.sharding import (
    P, Sharded, all_to_all, device_put, on_device, psum, rank_array,
)


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


def _ep_params(params, mesh, ep_axis):
    """The router replicated, w1 / w2 split over ``ep_axis`` by expert: each
    rank's shards (an object array of dicts)."""
    placed = {"router": device_put(params["router"], mesh, P(None, None))}
    for name in ("w1", "w2"):
        placed[name] = device_put(params[name], mesh, P(ep_axis, None, None))
    out = rank_array(mesh)
    for c in mesh.coords():
        out[c] = {name: t.shard(c) for name, t in placed.items()}
    return out


def _check_ep(cfg, ep):
    if cfg.num_experts % ep:
        raise ValueError(f"num_experts {cfg.num_experts} % ep {ep} != 0")
    return cfg.num_experts // ep


def moe_forward_ep(params, x, cfg: MoEConfig, mesh, *, ep_axis: str = "ep",
                   dp_axis: Optional[str] = "dp", activation=gelu_tanh) -> Sharded:
    """Expert-parallel MoE: experts split over ``ep_axis``, tokens (with
    ``dp_axis``) over ``dp_axis``.  Each rank routes its tokens with the
    replicated router, runs only its local experts (remote slots fall into
    the grouped kernel's zero tail) and a ``psum`` over ``ep_axis`` (tag
    ``"ep_psum"``) merges the disjoint partial outputs.  ``params`` and
    ``x`` are global tensors (or :class:`Sharded`); returns the output as a
    :class:`Sharded` laid out like ``x``, differentiable back to both."""
    per = _check_ep(cfg, mesh.shape[ep_axis])
    x_spec = P(dp_axis, None) if dp_axis else P(None, None)
    xs = device_put(x, mesh, x_spec)
    ps = _ep_params(params, mesh, ep_axis)
    part = rank_array(mesh)
    for c in mesh.coords():
        with on_device(mesh.devices[c]):
            p, xx = ps[c], xs.shard(c)
            expert_ids, mix = route(xx, p["router"], cfg.num_experts, cfg.top_k)
            part[c] = _local_expert_ffn(xx, expert_ids, mix, p["w1"], p["w2"],
                                        mesh.axis_index(c, ep_axis) * per, cfg, activation)
    y = psum(part, mesh, ep_axis, tag="ep_psum")
    for c in mesh.coords():
        y[c] = y[c].to(xs.dtype)
    return Sharded(mesh, x_spec, xs.shape, y)


def a2a_capacity(n_loc: int, top_k: int, ep: int, capacity_factor: float) -> int:
    """Slots a rank sends each destination rank: ceil(capacity_factor
    n_loc top_k / ep), rounded up to a multiple of 8 (JAX's sublane
    rounding, moe.py:294-295)."""
    cap = -(-int(capacity_factor * n_loc * top_k) // ep)
    return -(-cap // 8) * 8


def _a2a_pack(xx, p, cfg, ep, per, cap):
    """A rank's send buffers: (x rows (ep, cap, d), local expert ids (ep,
    cap), each slot's row pos (ep * cap: dropped), the sort order, mix)."""
    n_loc, d = xx.shape
    expert_ids, mix = route(xx, p["router"], cfg.num_experts, cfg.top_k)
    slots = expert_ids.reshape(-1)
    dest = slots // per
    order = torch.argsort(dest, stable=True)
    dest_sorted = dest[order]
    counts = _counts(dest, ep).long()
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(slots.numel(), device=xx.device) - start[dest_sorted]
    pos = torch.where(rank < cap, dest_sorted * cap + rank, ep * cap)
    feat = torch.index_select(xx, 0, order // cfg.top_k)
    lid = (slots[order] % per).to(torch.int32)
    send_x = torch.zeros((ep * cap + 1, d), dtype=xx.dtype, device=xx.device).index_put(
        (pos,), feat)
    send_id = torch.full((ep * cap + 1,), per, dtype=torch.int32, device=xx.device) \
        .index_put((pos,), lid)
    return send_x[:-1].reshape(ep, cap, d), send_id[:-1].reshape(ep, cap), pos, order, mix


def moe_forward_ep_a2a(params, x, cfg: MoEConfig, mesh, *, ep_axis: str = "ep",
                       activation=gelu_tanh, capacity_factor: float = 2.0) -> Sharded:
    """Expert-parallel MoE with ``all_to_all`` dispatch: tokens and experts
    both split over ``ep_axis``.  Each rank routes its tokens and packs the
    slots bound for each destination rank into a buffer of
    :func:`a2a_capacity` rows (the capacity pools a rank's ``per`` local
    experts, as JAX's does); one ``all_to_all`` (tag ``"all_to_all"``) sends
    the buffers and their local expert ids, the experts run on the received
    rows (padding rows carry id ``per``: the grouped kernel's zero tail), a
    second one returns the outputs, and the router's mix combines them.
    Slots past a destination's capacity are dropped: they contribute exactly
    zero.  Equal to ``moe_forward`` when nothing drops (``capacity_factor``
    >= ep).  Returns a :class:`Sharded` laid out like ``x`` (P(ep_axis,
    None)), differentiable back to ``params`` and ``x``."""
    ep = mesh.shape[ep_axis]
    per = _check_ep(cfg, ep)
    if x.shape[0] % ep:
        raise ValueError(f"tokens {x.shape[0]} % ep {ep} != 0 - x is sharded over "
                         f"'{ep_axis}', so the token count must divide the ep size")
    x_spec = P(ep_axis, None)
    xs = device_put(x, mesh, x_spec)
    ps = _ep_params(params, mesh, ep_axis)
    cap = a2a_capacity(x.shape[0] // ep, cfg.top_k, ep, capacity_factor)
    send_x, send_id, state = (rank_array(mesh) for _ in range(3))
    for c in mesh.coords():
        with on_device(mesh.devices[c]):
            send_x[c], send_id[c], *state[c] = _a2a_pack(xs.shard(c), ps[c], cfg, ep, per, cap)
    recv_x = all_to_all(send_x, mesh, ep_axis, 0, 0)
    recv_id = all_to_all(send_id, mesh, ep_axis, 0, 0)
    ys = rank_array(mesh)
    for c in mesh.coords():
        with on_device(mesh.devices[c]):
            p = ps[c]
            rx, rid = recv_x[c].reshape(ep * cap, -1), recv_id[c].reshape(ep * cap).long()
            xd, group_sizes, inv = _dispatch_ids(rx, rid, per + 1)
            group_sizes = group_sizes[:per]
            h = grouped_matmul(xd, p["w1"], group_sizes, cfg.gemm_cfg())
            h = activation(h).to(p["w2"].dtype)
            out = grouped_matmul(h, p["w2"], group_sizes, cfg.gemm_cfg())
            ys[c] = torch.index_select(out, 0, inv).reshape(ep, cap, -1)
    back = all_to_all(ys, mesh, ep_axis, 0, 0)
    y = rank_array(mesh)
    for c in mesh.coords():
        with on_device(mesh.devices[c]):
            pos, order, mix = state[c]
            b = back[c].reshape(ep * cap, -1)
            b = torch.cat([b, b.new_zeros((1, b.shape[1]))], 0)  # the dropped slots' row
            y_slot = torch.index_select(torch.index_select(b, 0, pos), 0, _inverse(order))
            n_loc = xs.shard(c).shape[0]
            y[c] = torch.sum(y_slot.reshape(n_loc, cfg.top_k, -1) * mix[..., None].to(b.dtype),
                             dim=1).to(xs.dtype)
    return Sharded(mesh, x_spec, xs.shape, y)
