"""The port's mixture-of-experts FFN (``models/moe.py``) against
``gemm_hls_tpu.models.moe`` on the CPU.

The JAX parameters (``init_moe_params``) are carried across with
``params_from_reference(..., device="cpu")``; both sides then run on the
same numpy tokens, the JAX side with its grouped Pallas kernel in
interpret mode, the port with its plain versions.  Tolerance: relative
error below 1e-4 of the largest output.  Routing ids must be equal, except
tokens whose JAX top-k margin (the gap between the k-th and the next
logit) is below 1e-5, where fp32 rounding may order them either way:
those are counted and reported, and left out of the output comparison.

Expert parallelism (``moe_forward_ep``, ``moe_forward_ep_a2a``) runs on CPU
ranks against JAX's on its virtual devices (``tests/test_moe.py``'s meshes
and sizes, each JAX call under one ``jax.jit``), output and gradients at rel
1e-3, the a2a's drop rule included.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.models import moe as jmoe
from gemm_hls_tpu_torch.models import moe

torch.set_num_threads(1)

TOL = 1e-4


def _setup(top_k, seed=0, tokens=64, d_model=32, d_ff=64, experts=8):
    jcfg = jmoe.MoEConfig(d_model=d_model, d_ff=d_ff, num_experts=experts,
                          top_k=top_k)
    cfg = moe.MoEConfig(d_model=d_model, d_ff=d_ff, num_experts=experts,
                        top_k=top_k)
    jp = jmoe.init_moe_params(jax.random.key(seed), jcfg)
    x = np.random.default_rng(seed + 1).standard_normal(
        (tokens, d_model)).astype(np.float32)
    return jcfg, cfg, jp, moe.params_from_reference(jp, device="cpu"), x


def _near_ties(x, router, top_k):
    """Tokens whose k-th and (k+1)-th router logits lie within 1e-5."""
    logits = np.sort(x.astype(np.float64) @ np.asarray(router, np.float64), -1)[:, ::-1]
    if top_k >= logits.shape[1]:
        return np.zeros(len(x), bool)
    return logits[:, top_k - 1] - logits[:, top_k] < 1e-5


def _rel(got, want, keep=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if keep is not None:
        got, want = got[keep], want[keep]
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_params_from_reference_bf16():
    jcfg = jmoe.MoEConfig(d_model=16, d_ff=32, num_experts=4, dtype="bfloat16")
    jp = jmoe.init_moe_params(jax.random.key(3), jcfg)
    p = moe.params_from_reference(jp, device="cpu")
    assert p["w1"].dtype == torch.bfloat16 and p["router"].dtype == torch.float32
    np.testing.assert_array_equal(p["w2"].float().numpy(),
                                  np.asarray(jp["w2"], np.float32))


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_route_and_dispatch_vs_jax(top_k):
    jcfg, cfg, jp, p, x = _setup(top_k, seed=top_k)
    jids, jmix = jmoe.route(jnp.asarray(x), jp["router"], 8, top_k)
    ids, mix = moe.route(torch.from_numpy(x), p["router"], 8, top_k)
    ties = _near_ties(x, jp["router"], top_k)
    same = (ids.numpy() == np.asarray(jids)).all(-1)
    print(f"top_k={top_k}: {int(ties.sum())} near-tie tokens, "
          f"{int((~same).sum())} routed differently")
    assert np.all(same | ties)
    assert _rel(mix.numpy(), jmix, same) < TOL
    jxs, jgs, jinv = jmoe._dispatch(jnp.asarray(x), jids, 8)
    xs, gs, inv = moe._dispatch(torch.from_numpy(x), torch.from_numpy(
        np.asarray(jids).astype(np.int64)), 8)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("with_aux", [False, True])
def test_moe_forward_vs_jax(top_k, with_aux):
    jcfg, cfg, jp, p, x = _setup(top_k, seed=10 + top_k)
    want = jmoe.moe_forward(jp, jnp.asarray(x), jcfg, with_aux=with_aux)
    got = moe.moe_forward(p, torch.from_numpy(x), cfg, with_aux=with_aux)
    if with_aux:
        (want, jaux), (got, aux) = want, got
        assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))
    keep = ~_near_ties(x, jp["router"], top_k)
    print(f"top_k={top_k}: {int((~keep).sum())} near-tie tokens left out")
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want, keep) < TOL


@pytest.mark.parametrize("local", [(0, 4), (2, 5), (7, 8)])
def test_local_experts_vs_jax(local):
    jcfg, cfg, jp, p, x = _setup(2, seed=20)
    want = jmoe.moe_forward(jp, jnp.asarray(x), jcfg, local_experts=local)
    got = moe.moe_forward(p, torch.from_numpy(x), cfg, local_experts=local)
    keep = ~_near_ties(x, jp["router"], 2)
    assert _rel(got.numpy(), want, keep) < TOL


def test_local_experts_sum_to_the_whole():
    _, cfg, _, p, x = _setup(2, seed=21)
    xt = torch.from_numpy(x)
    parts = sum(moe.moe_forward(p, xt, cfg, local_experts=(lo, lo + 2))
                for lo in range(0, 8, 2))
    assert _rel(parts.numpy(), moe.moe_forward(p, xt, cfg).numpy()) < 1e-6


@pytest.mark.parametrize("top_k", [1, 2])
def test_load_balance_loss_and_moe_loss_vs_jax(top_k):
    jcfg, cfg, jp, p, x = _setup(top_k, seed=30 + top_k)
    want = float(jmoe.load_balance_loss(jnp.asarray(x), jp["router"], 8, top_k))
    got = float(moe.load_balance_loss(torch.from_numpy(x), p["router"], 8, top_k))
    assert abs(got - want) <= TOL * abs(want)
    y = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    for aux_weight in (0.0, 0.01):
        jl = float(jmoe.moe_loss(jp, (jnp.asarray(x), jnp.asarray(y)), jcfg,
                                 aux_weight=aux_weight))
        tl = float(moe.moe_loss(p, (torch.from_numpy(x), torch.from_numpy(y)),
                                cfg, aux_weight=aux_weight))
        assert abs(tl - jl) <= TOL * abs(jl)


def test_gelu_is_jax_default():
    x = np.linspace(-5, 5, 101).astype(np.float32)
    np.testing.assert_allclose(moe.gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_init_moe_params_shapes():
    cfg = moe.MoEConfig(d_model=16, d_ff=24, num_experts=4, dtype="bfloat16")
    p = moe.init_moe_params(torch.Generator().manual_seed(0), cfg)
    assert p["router"].shape == (16, 4) and p["router"].dtype == torch.float32
    assert p["w1"].shape == (4, 16, 24) and p["w1"].dtype == torch.bfloat16
    assert p["w2"].shape == (4, 24, 16)


# ---- expert parallelism on CPU ranks against JAX's 8 virtual devices ------

def _ep_meshes(shape, names):
    from jax.sharding import Mesh

    from gemm_hls_tpu_torch.parallel import make_mesh
    n = int(np.prod(shape))
    return (make_mesh(shape, names, devices=["cpu"] * n),
            Mesh(np.array(jax.devices()[:n]).reshape(shape), names))


def _ep_setup(seed, tokens):
    # tests/test_moe.py's _cfg(): d 32, d_ff 48, 4 experts, top-2.
    from gemm_hls_tpu.config import GemmConfig as JaxConfig
    jcfg = jmoe.MoEConfig(d_model=32, d_ff=48, num_experts=4, top_k=2,
                          gemm=JaxConfig(block_m=128, block_n=128, block_k=128,
                                         interpret=True))
    cfg = moe.MoEConfig(d_model=32, d_ff=48, num_experts=4, top_k=2)
    jp = jmoe.init_moe_params(jax.random.key(seed), jcfg)
    x = np.random.default_rng(seed + 1).standard_normal((tokens, 32)).astype(np.float32)
    assert not _near_ties(x, jp["router"], 2).any()
    return jcfg, cfg, jp, x


@functools.partial(jax.jit, static_argnums=0)
def _jax_vjp(fn, *args):
    """fn's output and the gradient of sum(fn^2), under one jit (eager
    shard_map runs op by op)."""
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(2 * out)


# (form, mesh shape, axis names, tokens, capacity_factor): the JAX tests'
# meshes and sizes; capacity_factor = ep keeps every slot, 0.25 drops some.
EP_CASES = [("psum", (2, 4), ("dp", "ep"), 64, None),
            ("a2a", (4,), ("ep",), 32, 4.0),
            ("a2a", (4,), ("ep",), 64, 0.25)]


@pytest.mark.parametrize("case", EP_CASES, ids=lambda c: f"{c[0]}-{c[4]}")
def test_expert_parallel_vs_jax(case):
    """moe_forward_ep / moe_forward_ep_a2a on CPU ranks against JAX's on the
    same mesh: the output and the gradient of sum(y^2) with respect to
    every parameter and x, rel 1e-3 (fp32); under the tight capacity the
    same slots drop on both sides, and a row that lost no slot equals the
    no-drop output."""
    form, shape, names, tokens, cf = case
    jcfg, cfg, jp, x = _ep_setup(13, tokens)
    mesh, jmesh = _ep_meshes(shape, names)
    if form == "psum":
        jfn = lambda p, xx: jmoe.moe_forward_ep(p, xx, jcfg, jmesh)  # noqa: E731
        fn = lambda p, xx: moe.moe_forward_ep(p, xx, cfg, mesh)  # noqa: E731
    else:
        jfn = lambda p, xx: jmoe.moe_forward_ep_a2a(p, xx, jcfg, jmesh,  # noqa: E731
                                                     capacity_factor=cf)
        fn = lambda p, xx: moe.moe_forward_ep_a2a(p, xx, cfg, mesh,  # noqa: E731
                                                  capacity_factor=cf)
    jout, (jgrads, jgx) = _jax_vjp(jfn, jp, jnp.asarray(x))
    p = {k: v.requires_grad_() for k, v in moe.params_from_reference(jp, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = fn(p, tx)
    assert out.shape == x.shape and tuple(out.spec) == (P_EP[form], None)
    got = out.full()
    grads = torch.autograd.grad((got ** 2).sum(), [p["router"], p["w1"], p["w2"], tx])
    assert _rel(got.detach().numpy(), jout) < 1e-3
    for name, g, want in zip(("router", "w1", "w2", "x"), grads,
                             (jgrads["router"], jgrads["w1"], jgrads["w2"], jgx)):
        assert _rel(g.numpy(), want) < 1e-3, name
    if cf is not None and cf < shape[0]:
        full = moe.moe_forward(p, tx, cfg).detach().numpy()
        same = np.isclose(got.detach().numpy(), full, rtol=1e-5, atol=1e-6).all(axis=1)
        assert 0 < same.sum() < tokens  # some rows lost a slot, some none
        assert np.isfinite(got.detach().numpy()).all()


P_EP = {"psum": "dp", "a2a": "ep"}


def test_a2a_capacity_is_jax_rounding():
    for n_loc, top_k, ep, cf in [(16, 2, 4, 4.0), (16, 2, 4, 0.25), (1024, 2, 4, 4.0),
                                 (7, 3, 2, 1.3)]:
        cap = -(-int(cf * n_loc * top_k) // ep)
        assert moe.a2a_capacity(n_loc, top_k, ep, cf) == -(-cap // 8) * 8


def test_expert_parallel_refusals():
    _, cfg, _, x = _ep_setup(13, 64)
    p = moe.params_from_reference(jmoe.init_moe_params(
        jax.random.key(13), jmoe.MoEConfig(d_model=32, d_ff=48, num_experts=4)), device="cpu")
    mesh3, _ = _ep_meshes((3,), ("ep",))
    with pytest.raises(ValueError, match="num_experts"):
        moe.moe_forward_ep(p, torch.from_numpy(x), cfg, mesh3, dp_axis=None)
    mesh4, _ = _ep_meshes((4,), ("ep",))
    with pytest.raises(ValueError, match="tokens"):
        moe.moe_forward_ep_a2a(p, torch.from_numpy(x[:30]), cfg, mesh4)


# ---- moe_train_step: B16 and B17 through grouped_matmul's autograd --------

def _batch(x, seed=4):
    y = np.tanh(x @ np.random.default_rng(seed).standard_normal(
        (x.shape[1], x.shape[1])).astype(np.float32) / 4).astype(np.float32)
    return x, y


def _torch_batch(batch, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in batch)


@pytest.mark.parametrize("aux_weight", [0.0, 0.01])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_train_step_vs_jax(top_k, aux_weight):
    jcfg, cfg, jp, p, x = _setup(top_k, seed=40 + top_k)
    # No token sits near a routing tie, so both sides route alike and the
    # whole step is compared.
    assert not _near_ties(x, jp["router"], top_k).any()
    batch = _batch(x)
    jnew, jloss = jmoe.moe_train_step(jp, tuple(map(jnp.asarray, batch)), jcfg,
                                      lr=0.05, aux_weight=aux_weight)
    new, loss = moe.moe_train_step(p, _torch_batch(batch), cfg, lr=0.05,
                                   aux_weight=aux_weight)
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    for name in ("router", "w1", "w2"):
        assert new[name].dtype == p[name].dtype
        assert _rel(new[name].numpy(), jnew[name]) < TOL
        # The update itself, lr * grad, against JAX's.
        step = p[name].numpy() - new[name].numpy()
        assert _rel(step, np.asarray(jp[name]) - np.asarray(jnew[name])) < 1e-3


def test_train_step_reduces_loss_and_moves_router():
    # tests/test_moe.py:65, on the port's own init and GemmConfig.
    from gemm_hls_tpu_torch import GemmConfig
    cfg = moe.MoEConfig(d_model=32, d_ff=48, num_experts=4, top_k=2,
                        gemm=GemmConfig(block_m=16, block_n=16, block_k=16))
    params0 = moe.init_moe_params(torch.Generator().manual_seed(4), cfg)
    before = {k: v.clone() for k, v in params0.items()}
    x = np.random.default_rng(5).standard_normal((128, 32)).astype(np.float32)
    batch = _torch_batch(_batch(x, seed=6))
    params, losses = params0, []
    for _ in range(5):
        params, loss = moe.moe_train_step(params, batch, cfg, lr=0.05)
        losses.append(float(loss))
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    # The router receives gradient through the mix weights.
    assert float((params["router"] - params0["router"]).abs().max()) > 0
    # The given params are left as they were.
    assert all(torch.equal(params0[k], before[k]) for k in before)


def test_train_step_bf16_vs_jax():
    jcfg = jmoe.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                          dtype="bfloat16")
    cfg = moe.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                        dtype="bfloat16")
    jp = jmoe.init_moe_params(jax.random.key(50), jcfg)
    p = moe.params_from_reference(jp, device="cpu")
    x = np.random.default_rng(51).standard_normal((64, 32)).astype(np.float32)
    assert not _near_ties(x, jp["router"], 2).any()
    batch = _batch(x)
    jnew, jloss = jmoe.moe_train_step(jp, tuple(map(jnp.asarray, batch)), jcfg,
                                      lr=0.05)
    new, loss = moe.moe_train_step(p, _torch_batch(batch), cfg, lr=0.05)
    assert abs(float(loss) - float(jloss)) <= 1e-2 * abs(float(jloss))
    for name in ("router", "w1", "w2"):
        assert new[name].dtype == p[name].dtype
        assert _rel(new[name].float().numpy(), np.asarray(jnew[name], np.float32)) < 1e-2
        assert not torch.equal(new[name], p[name])


def test_train_step_with_gemm_config_vs_jax():
    # An explicit GemmConfig (dtype float32): the grouped GEMMs output fp32,
    # so the hidden layer stays fp32 through the GELU, as in JAX, and the
    # backward meets fp32 cotangents with bf16 weights.
    from gemm_hls_tpu.config import GemmConfig as JaxConfig
    from gemm_hls_tpu_torch import GemmConfig
    blocks = dict(block_m=16, block_n=16, block_k=16)
    jcfg = jmoe.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                          dtype="bfloat16", gemm=JaxConfig(**blocks, interpret=True))
    cfg = moe.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                        dtype="bfloat16", gemm=GemmConfig(**blocks))
    jp = jmoe.init_moe_params(jax.random.key(55), jcfg)
    p = moe.params_from_reference(jp, device="cpu")
    x = np.random.default_rng(56).standard_normal((64, 32)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)  # exact in bf16
    assert not _near_ties(x, jp["router"], 2).any()
    batch = _batch(x)
    jb = (jnp.asarray(batch[0], jnp.bfloat16), jnp.asarray(batch[1]))
    tb = (_torch_batch(batch)[0].bfloat16(), _torch_batch(batch)[1])
    jnew, jloss = jmoe.moe_train_step(jp, jb, jcfg, lr=0.05)
    new, loss = moe.moe_train_step(p, tb, cfg, lr=0.05)
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    for name in ("router", "w1", "w2"):
        assert _rel(new[name].float().numpy(), np.asarray(jnew[name], np.float32)) < 1e-2


def test_train_step_takes_lr_as_a_tensor():
    _, cfg, _, p, x = _setup(2, seed=60)
    batch = _torch_batch(_batch(x))
    want, wloss = moe.moe_train_step(p, batch, cfg, lr=0.05)
    got, loss = moe.moe_train_step(p, batch, cfg, lr=torch.tensor(0.05))
    assert torch.equal(loss, wloss)
    assert all(torch.equal(got[k], want[k]) for k in want)
