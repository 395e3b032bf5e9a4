"""The port's MLP trainer (``models/mlp.py``) and npz checkpoints
(``utils/checkpoint.py``) against the JAX package's ``tests/test_mlp.py``
(its single-device cases; the dp/tp sharding helpers belong to the port's
multi-GPU slice).

The JAX parameters from ``init_params`` become the port's through
``params_from_reference``; both sides then train on the same numpy batch,
the JAX side with its Pallas kernels in interpret mode, the port with its
plain versions (CPU tensors).  Tolerances: the loss to relative 1e-4 at
every step, the parameters to relative 1e-3 (absolute 1e-6), fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.config import GemmConfig as JaxConfig
from gemm_hls_tpu.models import mlp as jmlp

from gemm_hls_tpu_torch.models import mlp
from gemm_hls_tpu_torch.ops import mxu
from gemm_hls_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

JCFG = JaxConfig(block_m=16, block_n=128, block_k=128, interpret=True)
DIMS = (64, 128, 32)
LR = 1e-2


def _batch(n=32, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, DIMS[0])).astype(np.float32),
            rng.standard_normal((n, DIMS[-1])).astype(np.float32))


def _jax_step(params, batch, fused):
    """One SGD step of the JAX package: its own ``train_step`` unfused; for
    the fused forward (which its ``train_step`` does not expose) the same
    value_and_grad over ``mlp_forward(fused=True)``."""
    if not fused:
        return jmlp.train_step(params, batch, config=JCFG, lr=LR)

    def loss(p):
        return jnp.mean((jmlp.mlp_forward(p, batch[0], config=JCFG, fused=True)
                         - batch[1]) ** 2)

    value, grads = jax.value_and_grad(loss)(params)
    return jax.tree.map(lambda p, g: p - LR * g, params, grads), value


def test_params_from_reference():
    ref = jmlp.init_params(jax.random.PRNGKey(0), DIMS)
    params = mlp.params_from_reference(ref, device="cpu")
    assert len(params) == len(ref)
    for (w, b), (jw, jb) in zip(params, ref):
        assert w.dtype == b.dtype == torch.float32
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_params_from_reference_defaults_to_the_card():
    # Without a device the weights go to the card; with no card that
    # fails instead of silently staying on the CPU.
    ref = jmlp.init_params(jax.random.PRNGKey(0), DIMS)
    if torch.cuda.is_available():
        (w, _), _ = mlp.params_from_reference(ref)
        assert w.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            mlp.params_from_reference(ref)


def test_params_from_reference_bf16():
    ref = jmlp.init_params(jax.random.PRNGKey(0), DIMS, "bfloat16")
    (w, b), _ = mlp.params_from_reference(ref, device="cpu")
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(ref[0][0], np.float32))


@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_jax(fused):
    ref = jmlp.init_params(jax.random.PRNGKey(0), DIMS)
    x = _batch(16, 3)[0]
    got = mlp.mlp_forward(mlp.params_from_reference(ref, device="cpu"),
                          torch.from_numpy(x), fused=fused)
    exp = jmlp.mlp_forward(ref, jnp.asarray(x), config=JCFG, fused=fused)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_train_steps_match_jax(fused):
    ref = jmlp.init_params(jax.random.PRNGKey(0), DIMS)
    params = mlp.params_from_reference(ref, device="cpu")
    xb, yb = _batch()
    jbatch = (jnp.asarray(xb), jnp.asarray(yb))
    batch = (torch.from_numpy(xb), torch.from_numpy(yb))
    for _ in range(3):
        ref, jloss = _jax_step(ref, jbatch, fused)
        params, loss = mlp.train_step(params, batch, lr=LR, fused=fused)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        for (w, b), (jw, jb) in zip(params, ref):
            np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-3,
                                       atol=1e-6)
            np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-3,
                                       atol=1e-6)


def test_train_step_reduces_loss_and_keeps_inputs():
    params = mlp.init_params(torch.Generator().manual_seed(0), DIMS)
    w0 = params[0][0].clone()
    batch = mlp.make_batch(torch.Generator().manual_seed(2), 64, DIMS[0],
                           DIMS[-1])
    l0 = float(mlp.loss_fn(params, batch))
    p = params
    for _ in range(5):
        p, loss = mlp.train_step(p, batch, lr=LR, fused=True)
    assert float(loss) < l0
    assert torch.equal(params[0][0], w0)  # the step returns new params
    assert not p[0][0].requires_grad


def test_fused_training_matches_unfused():
    params = mlp.init_params(torch.Generator().manual_seed(0), DIMS)
    batch = mlp.make_batch(torch.Generator().manual_seed(1), 32, DIMS[0],
                           DIMS[-1])
    p_f, l_f = mlp.train_step(params, batch, lr=LR, fused=True)
    p_u, l_u = mlp.train_step(params, batch, lr=LR, fused=False)
    np.testing.assert_allclose(float(l_f), float(l_u), rtol=1e-6)
    for (wf, bf), (wu, bu) in zip(p_f, p_u):
        np.testing.assert_allclose(wf.numpy(), wu.numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(bf.numpy(), bu.numpy(), rtol=1e-5, atol=1e-7)


def test_init_params_he_scale():
    params = mlp.init_params(torch.Generator().manual_seed(0), (512, 1024, 8),
                             torch.bfloat16)
    (w, b), _ = params
    assert w.shape == (512, 1024) and w.dtype == torch.bfloat16
    assert torch.equal(b, torch.zeros(1024, dtype=torch.bfloat16))
    assert abs(float(w.float().std()) / (2 / 512) ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("fused", [False, True])
def test_module_matches_functional(fused):
    params = mlp.init_params(torch.Generator().manual_seed(4), DIMS)
    model = mlp.MLP(params, fused=fused)
    assert len(list(model.parameters())) == 2 * len(params)
    x = torch.from_numpy(_batch(8, 5)[0])
    out = model(x)
    np.testing.assert_array_equal(out.detach().numpy(), mlp.mlp_forward(
        params, x, fused=fused).numpy())
    out.sum().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_plain_forward_counts_no_launches():
    before = (mxu.mxu_matmul.launches, mxu.mxu_matmul.epilogue_launches)
    params = mlp.init_params(torch.Generator().manual_seed(0), DIMS)
    mlp.mlp_forward(params, torch.zeros(4, DIMS[0]), fused=True)
    assert (mxu.mxu_matmul.launches, mxu.mxu_matmul.epilogue_launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip_npz(tmp_path, dtype):
    params = mlp.init_params(torch.Generator().manual_seed(0), DIMS, dtype)
    path = save_checkpoint(str(tmp_path / "ck.npz"), params)
    restored = load_checkpoint(path, like=params)
    assert isinstance(restored, list) and isinstance(restored[0], tuple)
    for (w1, b1), (w2, b2) in zip(params, restored):
        assert w2.dtype == dtype
        assert torch.equal(w1, w2) and torch.equal(b1, b2)


def test_checkpoint_reads_a_reference_checkpoint(tmp_path):
    from gemm_hls_tpu.utils.checkpoint import save_checkpoint as jax_save

    ref = jmlp.init_params(jax.random.PRNGKey(1), DIMS)
    path = jax_save(str(tmp_path / "ref.npz"), ref)
    restored = load_checkpoint(
        path, like=mlp.params_from_reference(ref, device="cpu"))
    for (w, b), (jw, jb) in zip(restored, ref):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("bad,match", [("shape", "shape"), ("count", "leaves")])
def test_checkpoint_npz_rejects_mismatch(tmp_path, bad, match):
    state = {"w": torch.ones(4, 8), "b": torch.zeros(8)}
    path = save_checkpoint(str(tmp_path / "ck.npz"), state)
    template = ({"w": torch.ones(8, 4), "b": torch.zeros(8)} if bad == "shape"
                else {"w": torch.ones(4, 8)})
    with pytest.raises(ValueError, match=match):
        load_checkpoint(path, like=template)


def test_checkpoint_needs_npz(tmp_path):
    with pytest.raises(ValueError, match="npz"):
        save_checkpoint(str(tmp_path / "orbax_dir"), {"w": torch.ones(2)})
