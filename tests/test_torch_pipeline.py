"""The port's GPipe pipeline (``parallel/pipeline.py``) against
``gemm_hls_tpu.parallel.pipeline`` on the CPU.

The JAX side runs on the virtual CPU devices of ``tests/conftest.py``
(``tests/test_pipeline.py``'s sizes and config, its GEMM in interpret mode,
each call under one ``jax.jit``); the port on CPU ranks of one process (B1's
plain version), from the same numpy weights
(``pipeline.params_from_reference``) and batch.  The forward, the gradient
of the pipelined loss and one train step are held to JAX's at rel 1e-3
(fp32); the ``ppermute`` bytes to (T - 1) mb d 4 a rank each way.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gemm_hls_tpu.config import GemmConfig
from gemm_hls_tpu.parallel import pipeline as jpipe

from gemm_hls_tpu_torch.parallel import make_mesh, pipeline, sharding

torch.set_num_threads(1)

CFG = GemmConfig(block_m=8, block_n=128, block_k=128, interpret=True)


def _meshes(p):
    return (make_mesh((p,), ("pp",), devices=["cpu"] * p),
            Mesh(np.array(jax.devices()[:p]).reshape(p), ("pp",)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _setup(p, d_model=128, d_ffn=256, bsz=32, key=0):
    mesh, jmesh = _meshes(p)
    jp = jpipe.init_pipeline_params(jax.random.key(key), p, d_model, d_ffn)
    x = np.random.default_rng(key + 1).standard_normal((bsz, d_model)).astype(np.float32)
    return mesh, jmesh, jp, pipeline.params_from_reference(jp, device="cpu"), x


@pytest.mark.parametrize("p,m", [(2, 4), (4, 8), (4, 4)])
def test_pipeline_forward_matches_jax(p, m):
    mesh, jmesh, jp, tp, x = _setup(p)
    jfn = jax.jit(functools.partial(jpipe.pipeline_forward, mesh=jmesh, microbatches=m,
                                    config=CFG))
    want = jfn(jpipe.shard_pipeline_params(jp, jmesh), jnp.asarray(x))
    sharding.reset_bytes()
    got = pipeline.pipeline_forward(pipeline.shard_pipeline_params(tp, mesh),
                                    torch.from_numpy(x), mesh, microbatches=m)
    assert got.shape == x.shape and tuple(got.spec) == (None, None)
    for c in mesh.coords():  # replicated over the stages
        assert _rel(got.shard(c).numpy(), want) < 1e-3
    assert _rel(pipeline.stages_forward(tp, torch.from_numpy(x)).numpy(), want) < 1e-3
    steps, mb = m + p - 1, x.shape[0] // m
    assert set(sharding.BYTES["pipeline"].values()) == {(steps - 1) * mb * x.shape[1] * 4}


@pytest.mark.parametrize("remat", [True, False])
def test_pipeline_grads_match_jax(remat):
    """tests/test_pipeline.py's gradient case against jax.grad of JAX's
    pipelined loss; the backward's hops mirror the forward's."""
    mesh, jmesh, jp, tp, x = _setup(2, bsz=16)
    y = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    jgrad = jax.jit(jax.grad(functools.partial(jpipe.pipeline_loss, mesh=jmesh,
                                               microbatches=4, config=CFG)))(
        jpipe.shard_pipeline_params(jp, jmesh), (jnp.asarray(x), jnp.asarray(y)))
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    sharding.reset_bytes()
    pred = pipeline.pipeline_forward(leaves, torch.from_numpy(x), mesh, microbatches=4,
                                     remat=remat).full()
    loss = torch.mean((pred - torch.from_numpy(y)) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for name, g in zip(leaves, grads):
        assert _rel(g.numpy(), jgrad[name]) < 1e-3, name
    hops = (4 + 2 - 1 - 1) * (x.shape[0] // 4) * x.shape[1] * 4  # (T - 1) mb d 4
    assert set(sharding.BYTES["pipeline"].values()) == {hops}
    assert set(sharding.BYTES["pipeline_bwd"].values()) == {hops}


def test_pipeline_train_step_matches_jax():
    mesh, jmesh, jp, tp, x = _setup(4, bsz=32, key=10)
    y = 0.1 * x + 0.01
    jstep = jax.jit(functools.partial(jpipe.pipeline_train_step, mesh=jmesh, microbatches=8,
                                      config=CFG, lr=1e-2))
    jnew, jloss = jstep(jpipe.shard_pipeline_params(jp, jmesh), (jnp.asarray(x), jnp.asarray(y)))
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    new, loss = pipeline.pipeline_train_step(pipeline.shard_pipeline_params(tp, mesh), batch,
                                             mesh, microbatches=8, lr=1e-2)
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    for name in new:
        assert tuple(new[name].spec)[0] == "pp"
        assert _rel(new[name].full().numpy(), jnew[name]) < 1e-3, name
    after = pipeline.pipeline_loss(new, batch, mesh, microbatches=8)
    assert float(after) < float(loss)


def test_pipeline_microbatch_count_is_free():
    mesh, _, _, tp, x = _setup(2)
    xs = torch.from_numpy(x)
    o1 = pipeline.pipeline_forward(tp, xs, mesh, microbatches=2).full()
    o2 = pipeline.pipeline_forward(tp, xs, mesh, microbatches=8).full()
    assert _rel(o1.numpy(), o2.numpy()) < 1e-5


def test_pipeline_validates_shapes():
    mesh, _, _, tp, x = _setup(2)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_forward(tp, torch.from_numpy(x), mesh, microbatches=5)
    bad = pipeline.init_pipeline_params(torch.Generator().manual_seed(0), 3, 128, 256)
    with pytest.raises(ValueError, match="stages"):
        pipeline.pipeline_forward(bad, torch.from_numpy(x), mesh, microbatches=4)


def test_init_and_params_from_reference():
    g = torch.Generator().manual_seed(0)
    p = pipeline.init_pipeline_params(g, 3, 16, 32, dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {"w1": (3, 16, 32), "b1": (3, 32), "w2": (3, 32, 16), "b2": (3, 16)}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    jp = jpipe.init_pipeline_params(jax.random.key(1), 2, 8, 16)
    tp = pipeline.params_from_reference(jp, device="cpu")
    for name in jp:
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
