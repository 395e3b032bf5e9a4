"""Training through the CA-GEMM kernels: dp/tp-sharded MLP + checkpointing.

The port of ``examples/06_training.py`` to ``gemm_hls_tpu_torch``: the same
sizes, seeds, calls and printed lines.  The reference runs on a virtual
8-device CPU mesh; here the 8 ranks are explicit virtual ranks of one device
(``[torch.device("cuda")] * 8``), driven by one process: the tp ``psum`` of
the row-parallel layer and the dp gradient ``psum`` are copies between the
ranks' buffers (``parallel/sharding.py``) and every layer's GEMM launches
kernel B1 on the card.  ``--device cpu`` puts the ranks on the CPU, where
the kernels run their plain versions.  (The generators' numbers differ from
``jax.random``'s, so the losses do too.)

    python examples/torch/06_training.py [--device cuda|cpu]
"""

import argparse
import tempfile

import torch

from gemm_hls_tpu_torch.models.mlp import (
    batch_sharding, init_params, make_batch, shard_params, train_step,
)
from gemm_hls_tpu_torch.parallel import device_put, make_mesh
from gemm_hls_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")
    ranks = [torch.device(dev)] * 8

    mesh = make_mesh(axis_names=("dp", "tp"), devices=ranks)
    print(f"mesh: {dict(mesh.shape)}")

    dims = (256, 512, 256)
    gen = torch.Generator(device=dev)
    params = shard_params(init_params(gen.manual_seed(0), dims), mesh)
    batch = tuple(device_put(t, mesh, batch_sharding(mesh))
                  for t in make_batch(gen.manual_seed(1), 64, dims[0], dims[-1]))

    for step in range(5):
        params, loss = train_step(params, batch, lr=1e-2)
        print(f"step {step}: loss {float(loss):.4f}  "
              f"(W0 sharded {params[0][0].spec})")

    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(f"{d}/ck.npz", params)
        restored = load_checkpoint(path, like=params)
        for (w, b), (w2, b2) in zip(params, restored):
            if not (torch.equal(w.full(), w2.full()) and torch.equal(b.full(), b2.full())
                    and w2.spec == w.spec and b2.spec == b.spec):
                raise AssertionError("the restored params differ from the saved ones")
        print("checkpoint saved + restored:", path.split("/")[-1])


if __name__ == "__main__":
    main()
