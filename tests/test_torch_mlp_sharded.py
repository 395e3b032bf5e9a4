"""The port's dp / tp sharded MLP step (``models/mlp.py``:
``param_shardings``, ``shard_params``, ``batch_sharding``, ``train_step`` on
:class:`Sharded` params) and its sharded checkpoints, against
``gemm_hls_tpu.models.mlp`` on the CPU.

The JAX side runs GSPMD on the virtual CPU devices of ``tests/conftest.py``
(``tests/test_mlp.py``'s (dp 4, tp 2) mesh, dims and config, its GEMM in
interpret mode); the port on 8 CPU ranks of one process (B1's plain
version), from the same numpy weights (``params_from_reference``) and
batch.  Every new parameter is compared shard by shard at the same mesh
coordinate, with the same spec; the loss and the parameters within rel
1e-3 (fp32).  The collectives' bytes: each rank receives 2 (tp - 1) / tp
of its row-parallel partial in the forward's tp psum and again in its
backward.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from gemm_hls_tpu.config import GemmConfig
from gemm_hls_tpu.models import mlp as jmlp
from gemm_hls_tpu.parallel.mesh import make_mesh as jmake_mesh

from gemm_hls_tpu_torch.models import mlp
from gemm_hls_tpu_torch.parallel import P, Sharded, device_put, make_mesh
from gemm_hls_tpu_torch.parallel import sharding
from gemm_hls_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

CFG = GemmConfig(block_m=16, block_n=128, block_k=128, interpret=True)


def _meshes(shape=(4, 2)):
    n = int(np.prod(shape))
    return (make_mesh(shape, ("dp", "tp"), devices=["cpu"] * n),
            jmake_mesh(shape, axis_names=("dp", "tp")))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _strip(spec):
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def assert_shards(got: Sharded, want, rtol=1e-3):
    """Rank by rank, the port's shard against the JAX shard on the device at
    the same mesh coordinate, with the same spec."""
    jmesh = want.sharding.mesh
    assert got.shape == want.shape
    assert _strip(got.spec) == _strip(want.sharding.spec), (got.spec, want.sharding.spec)
    scale = np.abs(np.asarray(want)).max()
    for s in want.addressable_shards:
        coord = tuple(int(i) for i in np.argwhere(jmesh.devices == s.device)[0])
        np.testing.assert_allclose(got.shard(coord).numpy(), np.asarray(s.data),
                                   rtol=rtol, atol=rtol * scale, err_msg=str(coord))


def _setup(dims, batch_size, seed=0):
    jp = jmlp.init_params(jax.random.PRNGKey(seed), dims)
    jb = jmlp.make_batch(jax.random.PRNGKey(2), batch_size, dims[0], dims[-1])
    return jp, jb, mlp.params_from_reference(jp, device="cpu"), \
        tuple(torch.from_numpy(np.array(a)) for a in jb)


def test_layouts_are_jax_layouts():
    mesh, jmesh = _meshes()
    specs = mlp.param_shardings(mesh, 3)
    jspecs = jmlp.param_shardings(jmesh, 3)
    assert [tuple(map(_strip, pair)) for pair in specs] == \
        [(_strip(w.spec), _strip(b.spec)) for w, b in jspecs]
    assert _strip(mlp.batch_sharding(mesh)) == _strip(jmlp.batch_sharding(jmesh).spec)
    jp, _, p, _ = _setup((128, 256, 128), 32)
    for (w, b), (jw, jb) in zip(mlp.shard_params(p, mesh), jmlp.shard_params(jp, jmesh)):
        assert_shards(w, jw, rtol=0)
        assert_shards(b, jb, rtol=0)


@pytest.mark.parametrize("dims,steps", [((128, 256, 128), 1), ((128, 256, 128), 3),
                                        ((64, 128, 256, 64), 1)],
                         ids=["2-layers", "2-layers-3-steps", "3-layers"])
def test_sharded_step_matches_jax(dims, steps):
    """tests/test_mlp.py's sharded step: the port's params and loss after
    ``steps`` steps against JAX's GSPMD step, shard by shard (a third,
    column-parallel layer gathers its output columns over tp)."""
    mesh, jmesh = _meshes()
    jp, jb, p, b = _setup(dims, 32)
    jparams = jmlp.shard_params(jp, jmesh)
    jbatch = jax.device_put(jb, jmlp.batch_sharding(jmesh))
    params = mlp.shard_params(p, mesh)
    batch = tuple(device_put(t, mesh, mlp.batch_sharding(mesh)) for t in b)
    for _ in range(steps):
        jparams, jloss = jmlp.train_step(jparams, jbatch, config=CFG, lr=1e-2)
        params, loss = mlp.train_step(params, batch, lr=1e-2)
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    for (w, bb), (jw, jbb) in zip(params, jparams):
        assert_shards(w, jw)
        assert_shards(bb, jbb)


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_matches_unsharded(fused):
    """tests/test_mlp.py::test_sharded_matches_unsharded on the port: the
    sharded step (fused column layers too) equals the one-rank step."""
    mesh, _ = _meshes()
    _, _, p, b = _setup((128, 256, 128), 32)
    want, wloss = mlp.train_step(p, b, lr=1e-2, fused=fused)
    got, loss = mlp.train_step(mlp.shard_params(p, mesh), b, lr=1e-2, fused=fused)
    assert abs(float(loss) - float(wloss)) <= 1e-5 * abs(float(wloss))
    for (w, bb), (ww, wb) in zip(got, want):
        assert _rel(w.full().numpy(), ww.numpy()) < 1e-5
        assert _rel(bb.full().numpy(), wb.numpy()) < 1e-5
    assert got[0][0].spec == P(None, "tp") and got[1][0].spec == P("tp", None)


def test_sharded_step_bytes():
    """Per rank: the tp psum of the (B / dp, dout) fp32 partial, 2 (tp - 1) /
    tp of it each way; the gradient psums over dp (and dp x tp for the
    replicated bias)."""
    mesh, _ = _meshes()
    dims, batch = (128, 256, 128), 32
    _, _, p, b = _setup(dims, batch)
    sharding.reset_bytes()
    mlp.train_step(mlp.shard_params(p, mesh), b, lr=1e-2)
    dp, tp = 4, 2
    partial = batch // dp * dims[-1] * 4
    assert set(sharding.BYTES["tp_psum"].values()) == {2 * (tp - 1) * partial // tp}
    assert set(sharding.BYTES["tp_psum_bwd"].values()) == {2 * (tp - 1) * partial // tp}
    # w0 (128 x 128 a rank) + b0 (128) + w1 (128 x 128) over dp, b1 (128) over 8.
    shard = (128 * 128 + 128 + 128 * 128) * 4
    assert set(sharding.BYTES["grad_psum"].values()) == \
        {2 * (dp - 1) * shard // dp + 2 * 7 * 128 * 4 // 8}


def test_checkpoint_roundtrip_sharded(tmp_path):
    """Sharded params saved as their global tensors and restored into the
    template's mesh and layout; a shape mismatch raises."""
    mesh, _ = _meshes()
    _, _, p, _ = _setup((128, 256, 128), 32)
    params = mlp.shard_params(p, mesh)
    path = save_checkpoint(str(tmp_path / "ck.npz"), params)
    with np.load(path) as data:
        np.testing.assert_array_equal(data["arr_0"], p[0][0].numpy())
    back = load_checkpoint(path, like=params)
    for (w, b), (w2, b2) in zip(params, back):
        for x, y in ((w, w2), (b, b2)):
            assert isinstance(y, Sharded) and y.mesh is x.mesh and y.spec == x.spec
            for c in mesh.coords():
                assert torch.equal(x.shard(c), y.shard(c))
    bad = mlp.shard_params(mlp.params_from_reference(
        jmlp.init_params(jax.random.PRNGKey(0), (128, 128, 128)), device="cpu"), mesh)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, like=bad)


def test_checkpoint_roundtrip_bf16_sharded(tmp_path):
    mesh, _ = _meshes((2, 4))
    w = torch.randn(64, 32, dtype=torch.float32).bfloat16()
    x = device_put(w, mesh, P(None, "tp"))
    back = load_checkpoint(save_checkpoint(str(tmp_path / "b.npz"), {"w": x}), like={"w": x})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"].full(), w)


def test_jax_named_sharding_spec_reads_the_same():
    # The printed spec of example 06's W0 is JAX's.
    mesh, jmesh = _meshes((2, 4))
    assert repr(mlp.param_shardings(mesh, 2)[0][0]) == \
        repr(NamedSharding(jmesh, jmlp.param_shardings(jmesh, 2)[0][0].spec).spec)
