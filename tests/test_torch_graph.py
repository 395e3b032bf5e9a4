"""The port's graph applications (``models/graph.py``) and semiring
gradients (``ops/tropical_grad.py``) against ``gemm_hls_tpu``'s on the same
numpy inputs.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_graph.py`` and ``tests/test_tropical_grad.py`` do; the port
runs B1's and B3's plain versions, as CPU tensors do.  Tolerances: graph
results exact (min / max of identically rounded terms; PageRank's sums
relative 1e-6); gradients relative 1e-5, ties included (integer-valued
operands make ties common), against JAX's custom VJP and against plain
autograd through the dense ``(a[:, :, None] + b[None]).amin(1)`` form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu.models import graph as jax_graph

from gemm_hls_tpu_torch import matmul
from gemm_hls_tpu_torch.models import graph
from gemm_hls_tpu_torch.ops import tropical_grad
from gemm_hls_tpu_torch.utils import make_operands

torch.set_num_threads(1)

GRAPH_CFG = JaxConfig(block_m=8, block_n=16, block_k=8, interpret=True)
GRAD_CFG = JaxConfig(block_m=16, block_n=128, block_k=64, interpret=True)
SEMIRINGS = ["min_plus", "max_plus", "log_plus", "max_min", "min_max"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _graph(n, weights, density=0.3, seed=7):
    rng = np.random.default_rng(seed)
    w = (rng.integers(1, 10, (n, n)) if weights == "integer"
         else rng.uniform(1, 10, (n, n)))
    return np.where(rng.uniform(size=(n, n)) < density, w,
                    np.inf).astype(np.float32)


def _floyd_warshall(adj, plus=np.add, reduce=np.minimum):
    d = adj.copy()
    for k in range(d.shape[0]):
        d = reduce(d, plus(d[:, k:k + 1], d[k:k + 1, :]))
    return d


# ---- graph applications ----------------------------------------------------

@pytest.mark.parametrize("n", [24, 37])
@pytest.mark.parametrize("weights", ["integer", "uniform"])
def test_apsp_matches_jax_and_floyd_warshall(n, weights):
    adj = _graph(n, weights)
    got = graph.all_pairs_shortest_paths(_t(adj)).numpy()
    exp = np.asarray(jax_graph.all_pairs_shortest_paths(jnp.asarray(adj),
                                                        config=GRAPH_CFG))
    np.testing.assert_array_equal(got, exp)
    d0 = adj.copy()
    np.fill_diagonal(d0, 0.0)
    fw = _floyd_warshall(d0)
    if weights == "integer":
        np.testing.assert_array_equal(got, fw)
    else:  # path sums associate differently
        np.testing.assert_allclose(got, fw, rtol=1e-6)


def test_distance_product_matches_jax():
    adj = _graph(10, "uniform")
    np.fill_diagonal(adj, 0.0)
    got = graph.distance_product(_t(adj), _t(adj)).numpy()
    exp = np.asarray(jax_graph.distance_product(jnp.asarray(adj),
                                                jnp.asarray(adj),
                                                config=GRAPH_CFG))
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(
        got, np.min(adj[:, :, None] + adj[None, :, :], axis=1))


@pytest.mark.parametrize("n,density", [(16, 0.15), (40, 0.05)])
def test_transitive_closure_matches_jax(n, density):
    adj = np.random.default_rng(3).uniform(size=(n, n)) < density
    got = graph.transitive_closure(_t(adj))
    assert got.dtype == torch.bool
    exp = np.asarray(jax_graph.transitive_closure(jnp.asarray(adj),
                                                  config=GRAPH_CFG))
    np.testing.assert_array_equal(got.numpy(), exp)
    r = adj | np.eye(n, dtype=bool)
    for _ in range(n):
        r = r | ((r.astype(np.int32) @ r.astype(np.int32)) > 0)
    np.testing.assert_array_equal(got.numpy(), r)


@pytest.mark.parametrize("n", [12, 30])
def test_widest_paths_matches_jax(n):
    rng = np.random.default_rng(9)
    cap = np.where(rng.uniform(size=(n, n)) < 0.3,
                   rng.integers(1, 100, (n, n)), 0.0).astype(np.float32)
    got = graph.widest_paths(_t(cap)).numpy()
    exp = np.asarray(jax_graph.widest_paths(jnp.asarray(cap),
                                            config=GRAPH_CFG))
    np.testing.assert_array_equal(got, exp)
    w = cap.copy()
    np.fill_diagonal(w, np.inf)
    np.testing.assert_array_equal(
        got, _floyd_warshall(w, plus=np.minimum, reduce=np.maximum))


@pytest.mark.parametrize("n,iters", [(32, 100), (50, 20)])
def test_pagerank_matches_jax(n, iters):
    rng = np.random.default_rng(11)
    adj = (rng.uniform(size=(n, n)) < 0.2).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    adj[3] = 0.0  # a dangling node
    got = graph.pagerank(_t(adj), iters=iters).numpy()
    exp = np.asarray(jax_graph.pagerank(jnp.asarray(adj), config=GRAPH_CFG,
                                        iters=iters))
    np.testing.assert_allclose(got, exp, rtol=1e-6)
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("fn", ["apsp", "closure", "widest", "pagerank",
                                "distance"])
def test_matmul_fn_hook(fn):
    adj = _graph(9, "integer")
    calls = []

    def hook(x, y):
        calls.append(tuple(x.shape))
        sr = {"closure": "or_and", "widest": "max_min",
              "pagerank": "plus_times"}.get(fn, "min_plus")
        return matmul(x, y, semiring=sr, backend="torch")

    run = {"apsp": lambda: graph.all_pairs_shortest_paths(_t(adj), matmul_fn=hook),
           "closure": lambda: graph.transitive_closure(_t(np.isfinite(adj)),
                                                       matmul_fn=hook),
           "widest": lambda: graph.widest_paths(_t(adj), matmul_fn=hook),
           "pagerank": lambda: graph.pagerank(_t(adj), iters=5, matmul_fn=hook),
           "distance": lambda: graph.distance_product(_t(adj), _t(adj),
                                                      matmul_fn=hook)}[fn]
    default = {"apsp": lambda: graph.all_pairs_shortest_paths(_t(adj)),
               "closure": lambda: graph.transitive_closure(_t(np.isfinite(adj))),
               "widest": lambda: graph.widest_paths(_t(adj)),
               "pagerank": lambda: graph.pagerank(_t(adj), iters=5),
               "distance": lambda: graph.distance_product(_t(adj), _t(adj))}[fn]
    got, exp = run(), default()
    assert calls and torch.equal(got, exp) or (
        fn == "pagerank" and torch.allclose(got, exp, rtol=1e-6))
    n_calls = {"apsp": 3, "closure": 3, "widest": 3, "pagerank": 5,
               "distance": 1}[fn]
    assert len(calls) == n_calls


# ---- semiring gradients ----------------------------------------------------

def _operands(name, m, n, k, data, seed=0):
    lo, hi = {"log_plus": (-2.0, 2.0), "max_min": (0.0, 1000.0),
              "min_max": (0.0, 1000.0)}.get(name, (0.0, 100.0))
    if data == "continuous":
        return make_operands(m, n, k, "float32", low=lo, high=hi, seed=seed)
    # Integer values on a narrow range: ties at both the map and the reduce.
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 5, (m, k)).astype(np.float32),
            rng.integers(0, 5, (k, n)).astype(np.float32))


def _port_grads(a, b, g, name):
    x, y = _t(a).requires_grad_(), _t(b).requires_grad_()
    matmul(x, y, semiring=name).backward(_t(g))
    return x.grad.numpy(), y.grad.numpy()


def _jax_grads(a, b, g, name):
    def loss(x, y):
        return jnp.sum(jax_matmul(x, y, semiring=name, config=GRAD_CFG) * g)
    ga, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    return np.asarray(ga), np.asarray(gb)


def _close(got, exp, rtol=1e-5):
    np.testing.assert_allclose(got, exp, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(exp).max()))


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("data", ["continuous", "integer_ties"])
def test_gradients_match_jax(name, data):
    a, b = _operands(name, 11, 13, 15, data)
    g = np.random.default_rng(1).uniform(-1, 1, (11, 13)).astype(np.float32)
    for got, exp in zip(_port_grads(a, b, g, name), _jax_grads(a, b, g, name)):
        _close(got, exp)


def _dense_reference(name, x, y):
    """The semiring in plain torch ops, differentiated by autograd: amin /
    amax share a tied cotangent equally, minimum / maximum split a tie
    0.5 / 0.5, logsumexp gives the softmax weights."""
    x3, y3 = x[:, :, None], y[None, :, :]
    if name == "log_plus":
        return torch.logsumexp(x3 + y3, dim=1)
    if name in ("max_min", "min_max"):
        mapped = torch.minimum(x3, y3) if name == "max_min" else torch.maximum(x3, y3)
        return mapped.amax(1) if name == "max_min" else mapped.amin(1)
    return (x3 + y3).amin(1) if name == "min_plus" else (x3 + y3).amax(1)


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("data", ["continuous", "integer_ties"])
def test_gradients_match_plain_autograd(name, data):
    a, b = _operands(name, 20, 24, 33, data, seed=2)
    g = np.random.default_rng(3).uniform(-1, 1, (20, 24)).astype(np.float32)
    x, y = _t(a).requires_grad_(), _t(b).requires_grad_()
    _dense_reference(name, x, y).backward(_t(g))
    for got, exp in zip(_port_grads(a, b, g, name), (x.grad, y.grad)):
        _close(got, exp.numpy())


def test_tie_sharing():
    a = torch.tensor([[1.0, 1.0]], requires_grad=True)
    b = torch.tensor([[2.0], [2.0]])
    matmul(a, b, semiring="min_plus").sum().backward()
    np.testing.assert_array_equal(a.grad.numpy(), [[0.5, 0.5]])


@pytest.mark.parametrize("name", ["min_plus", "log_plus", "max_min"])
def test_cotangent_conserved_on_unaligned_shapes(name):
    a, b = _operands(name, 9, 17, 23, "continuous")
    x, y = _t(a).requires_grad_(), _t(b).requires_grad_()
    matmul(x, y, semiring=name).sum().backward()
    assert x.grad.shape == x.shape and y.grad.shape == y.shape
    # One unit of cotangent per output: into A's rows for the additive maps
    # (and again into B's columns), across dA and dB for selective maps.
    total = float(x.grad.sum() + y.grad.sum()) if name == "max_min" else float(x.grad.sum())
    np.testing.assert_allclose(total, 9 * 17, rtol=1e-5)


@pytest.mark.parametrize("name", ["min_plus", "max_min", "log_plus"])
def test_backward_chunk_width_changes_nothing(name, monkeypatch):
    # The port picks the K chunk from a memory budget; a budget of one
    # column per chunk must give the same gradients.
    a, b = _operands(name, 10, 12, 40, "integer_ties", seed=5)
    g = np.random.default_rng(6).uniform(-1, 1, (10, 12)).astype(np.float32)
    wide = _port_grads(a, b, g, name)
    monkeypatch.setattr(tropical_grad, "_CHUNK_BYTES", 10 * 12 * 4)
    narrow = _port_grads(a, b, g, name)
    for got, exp in zip(narrow, wide):
        _close(got, exp, rtol=1e-6)


@pytest.mark.parametrize("layout", ["3d_x_3d", "3d_x_2d", "2d_x_3d"])
def test_batched_gradients_match_jax_vmap(layout):
    rng = np.random.default_rng(21)
    a = rng.integers(0, 6, (2, 7, 9)).astype(np.float32)
    b = rng.integers(0, 6, (2, 9, 5)).astype(np.float32)
    if layout == "3d_x_2d":
        b = b[0]
    elif layout == "2d_x_3d":
        a = a[0]
    g = rng.uniform(-1, 1, (2, 7, 5)).astype(np.float32)
    got = _port_grads(a, b, g, "min_plus")
    for x, e in zip(got, _jax_grads(a, b, g, "min_plus")):
        assert x.shape == e.shape
        _close(x, e)


def test_forward_value_unchanged_and_transposed_route():
    a, b = make_operands(21, 33, 40, "float32")
    x = _t(a).requires_grad_()
    out = matmul(x, _t(b), semiring="min_plus")
    exp = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b),
                                semiring="min_plus", config=GRAD_CFG))
    np.testing.assert_array_equal(out.detach().numpy(), exp)
    assert out.grad_fn is not None
    # Transposed operands take B3 without the gradient route, as in JAX.
    out_t = matmul(_t(a.T.copy()), _t(b), semiring="min_plus", transpose_a=True)
    np.testing.assert_array_equal(out_t.numpy(), exp)


@pytest.mark.parametrize("name,flags", [("min_plus", dict(transpose_a=True)),
                                        ("plus_absdiff", {})])
def test_no_gradient_outside_the_supported_semirings(name, flags):
    a = torch.ones(4, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        matmul(a, torch.ones(4, 4), semiring=name, **flags)
    with torch.no_grad():  # the forward alone still runs
        assert matmul(a, torch.ones(4, 4), semiring=name, **flags).shape == (4, 4)


def test_tropical_matmul_refuses_other_semirings():
    with pytest.raises(ValueError, match="tropical_matmul supports"):
        tropical_grad.tropical_matmul(torch.ones(2, 2), torch.ones(2, 2),
                                      "plus_times", None)
