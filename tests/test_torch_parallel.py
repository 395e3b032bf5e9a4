"""The port's distributed CA-GEMMs (``parallel/sharding.py``, ``summa.py``,
``grid25d.py``, ``dispatch.py``, ``staging.distributed_streamed_matmul``)
against ``gemm_hls_tpu.parallel`` on the same numpy inputs.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``, as
``tests/test_parallel.py`` runs it; the port on 8 CPU ranks of one process
(the plain versions of B1 and B3).  Every sharded result is compared shard
by shard: the port's rank at mesh coordinate (i, j[, ...]) against JAX's
``addressable_shards`` entry on the device at the same coordinate, with
the same spec, which pins the z-major split of tuple axes and the layout of
``distributed_matmul``'s sliced result.  Sizes are ``tests/test_parallel.py``'s.
Tolerances: rel 1e-3 for float plus_times (different summation orders),
exact for min_plus / max_plus and integer results.  The byte counter of
the collectives equals ``models/scaling_model.comm_volume_per_device`` on
every rank.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from gemm_hls_tpu import parallel as jpar
from gemm_hls_tpu.models import graph as jax_graph

from gemm_hls_tpu_torch.models import graph
from gemm_hls_tpu_torch.models.scaling_model import comm_volume_per_device
from gemm_hls_tpu_torch.parallel import (
    P, Sharded, cannon_matmul, device_put, distributed_matmul,
    distributed_streamed_matmul, make_mesh, matmul_25d, mesh_25d, shard_operands_2d,
    shard_operands_25d, summa_matmul,
)
from gemm_hls_tpu_torch.parallel import sharding
from gemm_hls_tpu_torch.utils import make_operands, reference_matmul, verify_matmul

torch.set_num_threads(1)

RANKS = [torch.device("cpu")] * 8


def _mesh(shape, names=("x", "y")):
    n = int(np.prod(shape))
    return (make_mesh(shape, names, devices=RANKS[:n]),
            jpar.make_mesh(shape, names, devices=jax.devices()[:n]))


def _mesh25():
    return mesh_25d(c=2, devices=RANKS), jpar.mesh_25d(c=2)


def _strip(spec):
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def assert_shards(got: Sharded, want, exact=False, rtol=1e-3):
    """Rank by rank: the port's shard at each mesh coordinate against the
    JAX shard on the device at that coordinate."""
    assert isinstance(got, Sharded)
    jmesh = want.sharding.mesh
    assert dict(got.mesh.shape) == dict(jmesh.shape)
    assert got.shape == want.shape
    assert _strip(got.spec) == _strip(want.sharding.spec), (got.spec, want.sharding.spec)
    shards = want.addressable_shards
    assert len(shards) == got.mesh.devices.size
    for s in shards:
        coord = tuple(int(i) for i in np.argwhere(jmesh.devices == s.device)[0])
        g = got.shard(coord).float().numpy() if got.dtype == torch.bfloat16 else \
            got.shard(coord).numpy()
        w = np.asarray(s.data).astype(g.dtype)
        assert g.shape == w.shape, (coord, g.shape, w.shape)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=str(coord))
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=str(coord))


# ---- meshes, layouts, collectives -----------------------------------------

def test_make_mesh_auto_square():
    mesh = make_mesh(devices=RANKS)
    assert mesh.devices.size == 8 and mesh.shape == {"x": 2, "y": 4}
    assert mesh_25d(c=2, devices=RANKS).shape == {"z": 2, "x": 2, "y": 2}


def test_make_mesh_too_many():
    with pytest.raises(ValueError, match="needs"):
        make_mesh((4, 4), devices=RANKS)


@pytest.mark.parametrize("spec", [("x", "y"), ("y", "x"), ("x", ("z", "y")),
                                  (("z", "x"), "y"), (None, ("x", "z")), ("x", None)])
def test_device_put_layout_matches_jax(spec):
    """Each rank holds the range JAX's NamedSharding gives the device at its
    coordinate: tuple axes split major first (z-major here)."""
    mesh, jmesh = _mesh25()
    x = np.arange(16 * 24, dtype=np.float32).reshape(16, 24)
    got = device_put(x, mesh, P(*spec))
    want = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, JP(*spec)))
    assert_shards(got, want, exact=True)
    np.testing.assert_array_equal(got.full().numpy(), x)
    assert repr(got.spec) == repr(want.sharding.spec)


def _jax_collective(jmesh, fn, in_spec, out_spec, x):
    return jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=(in_spec,),
                                 out_specs=out_spec, check_vma=False))(x)


@pytest.mark.parametrize("case", [
    ("all_gather y tiled", "y", dict(dim=1, tiled=True)),
    ("all_gather x untiled", "x", dict(dim=0, tiled=False)),
    ("all_gather (z, y)", ("z", "y"), dict(dim=1, tiled=True)),
    ("psum z", "z", {}),
    ("psum (x, y)", ("x", "y"), {}),
    ("ppermute y", "y", dict(perm=[(0, 1), (1, 0)])),
    ("ppermute (x, y) skew", ("x", "y"), dict(perm=[(i * 2 + j, i * 2 + (j - i) % 2)
                                                    for i in range(2) for j in range(2)])),
    ("ppermute partial", ("z", "x"), dict(perm=[(0, 3), (3, 1)])),
], ids=lambda c: c[0])
def test_collectives_match_jax(case):
    """all_gather / psum / ppermute on every rank against ``jax.lax``'s inside
    ``shard_map``, over single and tuple axes of the (z, x, y) mesh; a rank
    no ppermute pair names gets zeros."""
    name, axes, kw = case
    mesh, jmesh = _mesh25()
    spec = (("z", "x"), "y")
    x = np.random.default_rng(3).uniform(-1, 1, (8, 12)).astype(np.float32)
    got_in = device_put(x, mesh, P(*spec))
    if name.startswith("all_gather"):
        got = sharding.all_gather(got_in.shards, mesh, axes, **kw)
        fn = functools.partial(jax.lax.all_gather, axis_name=axes, axis=kw["dim"],
                               tiled=kw["tiled"])
    elif name.startswith("psum"):
        got = sharding.psum(got_in.shards, mesh, axes)
        fn = functools.partial(jax.lax.psum, axis_name=axes)
    else:
        got = sharding.ppermute(got_in.shards, mesh, axes, kw["perm"])
        fn = functools.partial(jax.lax.ppermute, axis_name=axes, perm=kw["perm"])
    # Each device's own result, stacked over the mesh's axes in order.
    out_spec = JP(("z", "x", "y"))
    want = np.asarray(_jax_collective(
        jmesh, lambda b: fn(b)[None], JP(*spec), out_spec,
        jax.device_put(jnp.asarray(x), NamedSharding(jmesh, JP(*spec)))))
    for coord in mesh.coords():
        idx = mesh.axis_index(coord, ("z", "x", "y"))
        # psum adds in its ring's order: fp32 rounding of O(1) sums.
        np.testing.assert_allclose(got[coord].numpy(), want[idx], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} {coord}")


_GRAD_CASES = [
    ("all_gather y tiled", "y", dict(dim=1, tiled=True)),
    ("all_gather (z, y) untiled", ("z", "y"), dict(dim=0, tiled=False)),
    ("psum z", "z", {}),
    ("psum (x, y)", ("x", "y"), {}),
    ("ppermute y", "y", dict(perm=[(0, 1), (1, 0)])),
    ("ppermute partial", ("z", "x"), dict(perm=[(0, 3), (3, 1)])),
    ("all_to_all y untiled", "y", dict(split_dim=0, concat_dim=0, tiled=False)),
    ("all_to_all (x, y) tiled", ("x", "y"), dict(split_dim=1, concat_dim=0, tiled=True)),
    ("all_to_all z tiled", "z", dict(split_dim=0, concat_dim=1, tiled=True)),
]


@pytest.mark.parametrize("case", _GRAD_CASES, ids=lambda c: c[0])
def test_collective_gradients_match_jax(case):
    """Each collective (all_to_all's forward too) against ``jax.lax``'s inside
    ``shard_map`` on the (z, x, y) mesh, and the gradient of
    sum_rank(w_rank * out_rank) with respect to the global input against
    ``jax.grad`` of the same function: the backward is the adjoint of the
    forward's copies (a reduce-scatter, a psum, the inverse permutation,
    the reverse all_to_all), counted under the forward's tag + "_bwd"."""
    name, axes, kw = case
    mesh, jmesh = _mesh25()
    spec = (("z", "x"), "y")
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (8, 24)).astype(np.float32)
    if name.startswith("all_gather"):
        fn = functools.partial(sharding.all_gather, dim=kw["dim"], tiled=kw["tiled"])
        jfn = functools.partial(jax.lax.all_gather, axis_name=axes, axis=kw["dim"],
                                tiled=kw["tiled"])
    elif name.startswith("psum"):
        fn, jfn = sharding.psum, functools.partial(jax.lax.psum, axis_name=axes)
    elif name.startswith("ppermute"):
        fn = functools.partial(sharding.ppermute, perm=kw["perm"])
        jfn = functools.partial(jax.lax.ppermute, axis_name=axes, perm=kw["perm"])
    else:
        fn = functools.partial(sharding.all_to_all, **kw)
        jfn = functools.partial(jax.lax.all_to_all, axis_name=axes, split_axis=kw["split_dim"],
                                concat_axis=kw["concat_dim"], tiled=kw["tiled"])
    # Each rank's block is (2, 12): the untiled all_to_all's split dim has
    # the y group's size, the tiled ones' divide by theirs.
    spmd = jax.shard_map(lambda b: jfn(b)[None], mesh=jmesh, in_specs=(JP(*spec),),
                         out_specs=JP(("z", "x", "y")), check_vma=False)
    out_shape = jax.eval_shape(spmd, jax.ShapeDtypeStruct(x.shape, jnp.float32)).shape
    w = rng.uniform(-1, 1, out_shape).astype(np.float32)

    def jloss(xx):
        out = spmd(xx)
        return jnp.sum(out * w), out

    (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    placed = device_put(tx, mesh, P(*spec))
    sharding.reset_bytes()
    got = fn(placed.shards, mesh, axes)
    loss = 0
    for c in mesh.coords():
        idx = mesh.axis_index(c, ("z", "x", "y"))
        np.testing.assert_allclose(got[c].detach().numpy(), np.asarray(want)[idx],
                                   rtol=1e-6, atol=1e-6, err_msg=f"{name} {c}")
        loss = loss + (got[c] * torch.from_numpy(w[idx])).sum()
    (grad,) = torch.autograd.grad(loss, tx)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6,
                               err_msg=name)
    tag = name.split()[0]
    assert (tag + "_bwd" in sharding.BYTES) == any(sharding.BYTES[tag].values())


def test_mesh_groups_follow_axis_index():
    mesh, _ = _mesh25()
    for axes in ("y", ("z", "y"), ("x", "z", "y")):
        for group in mesh.groups(axes):
            assert [mesh.axis_index(c, axes) for c in group] == list(range(len(group)))
    assert sum(len(g) for g in mesh.groups(("z", "x"))) == 8


# ---- SUMMA, Cannon, 2.5D ----------------------------------------------------

@pytest.mark.parametrize("semiring,mnk", [("plus_times", (64, 128, 64)),
                                          ("min_plus", (32, 64, 32))])
def test_summa_matches_jax(semiring, mnk):
    mesh, jmesh = _mesh((2, 4))
    a, b = make_operands(*mnk[:2], mnk[2], "float32")
    got = summa_matmul(*shard_operands_2d(a, b, mesh), mesh, semiring=semiring)
    want = jpar.summa_matmul(*jpar.shard_operands_2d(jnp.asarray(a), jnp.asarray(b), jmesh),
                             jmesh, semiring=semiring)
    assert_shards(got, want, exact=semiring != "plus_times")
    verify_matmul(got.full().numpy(), reference_matmul(a, b, semiring=semiring))


@pytest.mark.parametrize("ta,tb", [(True, False), (False, True), (True, True)])
def test_summa_transposed_matches_jax(ta, tb):
    mesh, jmesh = _mesh((2, 4))
    a, b = make_operands(64, 128, 64, "float32", transpose_a=ta, transpose_b=tb)
    a_spec = ("y", "x") if ta else ("x", "y")
    b_spec = ("y", "x") if tb else ("x", "y")
    got = summa_matmul(device_put(a, mesh, P(*a_spec)), device_put(b, mesh, P(*b_spec)),
                       mesh, transpose_a=ta, transpose_b=tb)
    want = jpar.summa_matmul(
        jax.device_put(jnp.asarray(a), NamedSharding(jmesh, JP(*a_spec))),
        jax.device_put(jnp.asarray(b), NamedSharding(jmesh, JP(*b_spec))),
        jmesh, transpose_a=ta, transpose_b=tb)
    assert_shards(got, want)
    verify_matmul(got.full().numpy(),
                  reference_matmul(a, b, transpose_a=ta, transpose_b=tb))


def test_summa_int8_exact_and_out_dtype():
    mesh, jmesh = _mesh((2, 4))
    a, b = make_operands(32, 64, 64, "int8", low=-3, high=3)
    got = summa_matmul(a, b, mesh, out_dtype="int32")
    want = jpar.summa_matmul(jnp.asarray(a), jnp.asarray(b), jmesh, out_dtype="int32")
    assert got.dtype == torch.int32
    assert_shards(got, want, exact=True)


def test_summa_shape_validation():
    mesh, _ = _mesh((2, 4))
    with pytest.raises(ValueError, match="not divisible"):
        summa_matmul(torch.zeros(66, 64), torch.zeros(64, 130), mesh)


@pytest.mark.parametrize("semiring,mnk", [("plus_times", (64, 64, 64)),
                                          ("min_plus", (32, 32, 64))])
def test_cannon_matches_jax(semiring, mnk):
    mesh, jmesh = _mesh((2, 2))
    a, b = make_operands(*mnk[:2], mnk[2], "float32")
    got = cannon_matmul(*shard_operands_2d(a, b, mesh), mesh, semiring=semiring)
    want = jpar.cannon_matmul(*jpar.shard_operands_2d(jnp.asarray(a), jnp.asarray(b), jmesh),
                              jmesh, semiring=semiring)
    assert_shards(got, want, exact=semiring != "plus_times")
    verify_matmul(got.full().numpy(), reference_matmul(a, b, semiring=semiring))


def _bf16_operands(m, n, k):
    """The same bf16 operands as numpy (ml_dtypes, for JAX) and torch."""
    a, b = make_operands(m, n, k, "float32")
    a, b = a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return a, b, (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16),
                  torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16))


def test_cannon_bf16_accumulates_in_fp32():
    """Cannon's partials combine in the accumulator type and are cast once:
    bf16 operands give the bf16 rounding of the fp32 product."""
    mesh, jmesh = _mesh((2, 2))
    a, b, (ta, tb) = _bf16_operands(32, 32, 256)
    got = cannon_matmul(ta, tb, mesh)
    want = jpar.cannon_matmul(jnp.asarray(a), jnp.asarray(b), jmesh)
    assert got.dtype == torch.bfloat16
    assert_shards(got, want, rtol=1e-2)


def test_cannon_rejects_rectangular():
    mesh, _ = _mesh((2, 4))
    with pytest.raises(ValueError, match="square"):
        cannon_matmul(torch.zeros(8, 8), torch.zeros(8, 8), mesh)


@pytest.mark.parametrize("semiring,mnk", [("plus_times", (64, 64, 128)),
                                          ("max_plus", (32, 64, 64))])
def test_25d_matches_jax(semiring, mnk):
    mesh, jmesh = _mesh25()
    a, b = make_operands(*mnk[:2], mnk[2], "float32")
    got = matmul_25d(*shard_operands_25d(a, b, mesh), mesh, semiring=semiring)
    want = jpar.matmul_25d(*jpar.shard_operands_25d(jnp.asarray(a), jnp.asarray(b), jmesh),
                           jmesh, semiring=semiring)
    assert_shards(got, want, exact=semiring != "plus_times")
    verify_matmul(got.full().numpy(), reference_matmul(a, b, semiring=semiring))


def test_25d_rejects_indivisible_k():
    mesh, _ = _mesh25()
    with pytest.raises(ValueError, match="not divisible"):
        matmul_25d(torch.zeros(8, 6), torch.zeros(6, 8), mesh)


# ---- bytes moved against the scaling model ----------------------------------

@pytest.mark.parametrize("algorithm,dtype", [("summa", "float32"), ("summa", "bfloat16"),
                                             ("cannon", "float32"), ("cannon", "bfloat16"),
                                             ("25d", "float32"), ("25d", "bfloat16")])
def test_bytes_equal_comm_volume(algorithm, dtype):
    """Every rank receives exactly ``comm_volume_per_device``'s bytes
    (Cannon: in its shifts, the skew apart; 2.5D: its C reduction in the
    accumulator type)."""
    m, n, k = 64, 128, 128
    a, b = make_operands(m, n, k, "float32")
    a, b = torch.from_numpy(a).to(getattr(torch, dtype)), torch.from_numpy(b).to(getattr(torch, dtype))
    item = a.element_size()
    if algorithm == "25d":
        mesh, _ = _mesh25()
        a_s, b_s = shard_operands_25d(a, b, mesh)
        sharding.reset_bytes()
        matmul_25d(a_s, b_s, mesh)
        shape = (2, 2, 2)
    else:
        mesh, _ = _mesh((2, 4) if algorithm == "summa" else (2, 2))
        a_s, b_s = shard_operands_2d(a, b, mesh)
        sharding.reset_bytes()
        (summa_matmul if algorithm == "summa" else cannon_matmul)(a_s, b_s, mesh)
        shape = tuple(mesh.shape.values())
    want = comm_volume_per_device(algorithm, m, n, k, shape, item)
    tags = ["ppermute"] if algorithm == "cannon" else None
    got = sharding.bytes_received(mesh, tags)
    assert (got == want).all(), (got, want)
    if algorithm == "cannon":  # the skew: rank (i, j) gets A unless i = 0, B unless j = 0
        skew = sharding.bytes_received(mesh, ["skew"])
        blk_a, blk_b = (m // 2) * (k // 2) * item, (k // 2) * (n // 2) * item
        assert skew.tolist() == [[0, blk_b], [blk_a, blk_a + blk_b]]


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
def test_comm_volume_reduces_in_accumulator_type(itemsize):
    """2.5D's C reduction is charged in the plus_times accumulator type
    (int32 for int8, fp32 for 2-byte floats), the JAX model's operand-width
    charge otherwise unchanged."""
    from gemm_hls_tpu.models.scaling_model import comm_volume_per_device as jax_volume
    m, n, k, shape = 512, 256, 1024, (2, 2, 2)
    operands = jax_volume("summa", m, n, k // 2, shape[1:], itemsize)
    reduce_elems = (jax_volume("25d", m, n, k, shape, itemsize) - operands) // itemsize
    assert comm_volume_per_device("25d", m, n, k, shape, itemsize) == \
        operands + reduce_elems * max(itemsize, 4)


# ---- distributed_matmul -----------------------------------------------------

@pytest.mark.parametrize("algorithm,shape,mesh_shape", [
    ("summa", (17, 19, 23), (2, 4)),      # every dim ragged: C replicated
    ("summa", (16, 19, 32), (2, 4)),      # N cut: P(x)
    ("summa", (17, 16, 32), (2, 4)),      # M cut: P(None, y)
    ("summa", (16, 16, 33), (2, 4)),      # K padded only: P(x, y)
    ("cannon", (17, 15, 13), (2, 2)),
    ("auto", (16, 16, 16), (2, 2)),
])
def test_distributed_matmul_matches_jax(algorithm, shape, mesh_shape):
    m, n, k = shape
    mesh, jmesh = _mesh(mesh_shape)
    a, b = make_operands(m, n, k, "float32")
    got = distributed_matmul(a, b, mesh, algorithm=algorithm)
    want = jpar.distributed_matmul(jnp.asarray(a), jnp.asarray(b), jmesh, algorithm=algorithm)
    assert_shards(got, want)
    verify_matmul(got.full().numpy(), reference_matmul(a, b))


@pytest.mark.parametrize("semiring", ["min_plus", "max_min"])
def test_distributed_matmul_semiring_transposed(semiring):
    mesh, jmesh = _mesh((2, 4))
    a, b = make_operands(17, 19, 23, "float32", transpose_a=True)
    got = distributed_matmul(a, b, mesh, semiring=semiring, transpose_a=True)
    want = jpar.distributed_matmul(jnp.asarray(a), jnp.asarray(b), jmesh,
                                   semiring=semiring, transpose_a=True)
    assert_shards(got, want, exact=True)
    verify_matmul(got.full().numpy(),
                  reference_matmul(a, b, semiring=semiring, transpose_a=True))


def test_distributed_matmul_refusals():
    mesh, _ = _mesh((2, 4))
    sq, _ = _mesh((2, 2))
    a = torch.ones(8, 7)
    with pytest.raises(ValueError, match="unknown algorithm"):
        distributed_matmul(a, a.T, mesh, algorithm="ring")
    with pytest.raises(ValueError, match="square"):
        distributed_matmul(a, a.T, mesh, algorithm="cannon")
    with pytest.raises(ValueError, match="transpose"):
        distributed_matmul(a, a, sq, algorithm="cannon", transpose_b=True)
    with pytest.raises(ValueError, match="absorbing"):
        distributed_matmul(a, a.T, mesh, semiring="max_times")
    with pytest.raises(ValueError, match="contraction"):
        distributed_matmul(a, a, mesh)


# ---- distributed streamed GEMM ----------------------------------------------

@pytest.mark.parametrize("case", [
    ("summa", "plus_times", (2, 4), (32, 64, 128), (32, 32, 64)),
    ("25d", "min_plus", None, (32, 32, 128), (32, 16, 64)),
    ("summa", "plus_times", (2, 4), (17, 19, 23), (16, 16, 16)),   # ragged tiles
    ("25d", "plus_times", None, (17, 19, 23), (16, 16, 16)),
], ids=lambda c: f"{c[0]}-{c[1]}-{c[3]}")
def test_distributed_streamed_matches_jax(case):
    algorithm, semiring, mesh_shape, (m, n, k), (tm, tn, tk) = case
    mesh, jmesh = _mesh25() if mesh_shape is None else _mesh(mesh_shape)
    a, b = make_operands(m, n, k, "float32")
    kw = dict(algorithm=algorithm, semiring=semiring, tile_m=tm, tile_n=tn, tile_k=tk)
    got = distributed_streamed_matmul(a, b, mesh, **kw)
    stats = distributed_streamed_matmul.last_stats
    assert stats["jobs"] == -(-m // tm) * -(-n // tn) * -(-k // tk)
    assert stats["h2d_bytes"] == 4 * (-(-n // tn) * m * k + -(-m // tm) * k * n)
    want = jpar.distributed_streamed_matmul(a, b, jmesh, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    if semiring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)
    verify_matmul(got, reference_matmul(a, b, semiring=semiring))


def test_distributed_streamed_bf16_accumulates_wide():
    """Cross-panel partials accumulate in fp32 (one bf16 rounding per panel
    would breach 1e-3), as the JAX test holds its own."""
    mesh, jmesh = _mesh((2, 4))
    a, b, (ta, tb) = _bf16_operands(16, 32, 512)
    kw = dict(tile_m=16, tile_n=32, tile_k=64, out_dtype="float32")
    got = distributed_streamed_matmul(ta, tb, mesh, **kw)
    want = jpar.distributed_streamed_matmul(a, b, jmesh, **kw)
    exp = a.astype(np.float64) @ b.astype(np.float64)
    assert got.dtype == torch.float32
    assert (np.abs(got.numpy() - exp) / np.abs(exp)).max() < 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3)


# ---- distributed APSP through the graph layer's hook -------------------------

def test_distributed_apsp_matches_jax_and_single_rank():
    mesh, jmesh = _mesh((2, 2))
    n = 32
    rng = np.random.default_rng(7)
    w = rng.integers(1, 10, (n, n)).astype(np.float32)
    adj = np.where(rng.uniform(size=(n, n)) < 0.2, w, np.inf).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    got = graph.all_pairs_shortest_paths(
        torch.from_numpy(adj),
        matmul_fn=functools.partial(summa_matmul, mesh=mesh, semiring="min_plus"))
    want = jax_graph.all_pairs_shortest_paths(
        jax.device_put(jnp.asarray(adj), NamedSharding(jmesh, JP("x", "y"))),
        matmul_fn=functools.partial(jpar.summa_matmul, mesh=jmesh, semiring="min_plus"))
    assert_shards(got, want, exact=True)
    single = graph.all_pairs_shortest_paths(torch.from_numpy(adj))
    np.testing.assert_array_equal(got.full().numpy(), single.numpy())
