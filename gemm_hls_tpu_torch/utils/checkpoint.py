"""Checkpoint / resume of training state as a flat ``.npz``.

Counterpart of the ``.npz`` half of ``gemm_hls_tpu/utils/checkpoint.py``
(its Orbax half stays with the JAX package).  State is any nesting of
lists, tuples and dicts over tensors or numpy arrays; leaves are saved as
``arr_<i>`` in flattening order (dict keys sorted), and restored into the
structure, dtypes and devices of a ``like`` template, with a leaf count and
shape check.  numpy has no bfloat16, so a bf16 tensor is saved as the int16
view of its bits and restored through the template's dtype.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _flatten(tree, out):
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten(tree[key], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _flatten(x, out)
    else:
        out.append(tree)
    return out


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _restore(a, like):
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(a)
        t = t.view(torch.bfloat16) if like.dtype == torch.bfloat16 else t
        return t.to(dtype=like.dtype, device=like.device)
    return np.asarray(a, dtype=np.asarray(like).dtype)


def save_checkpoint(path: str, state: Any) -> str:
    """Save a nesting of tensors / arrays to ``path`` (must end in .npz)."""
    if not path.endswith(".npz"):
        raise ValueError(f"the port saves .npz checkpoints only, got {path!r}")
    leaves = _flatten(state, [])
    np.savez(path, **{f"arr_{i}": _to_numpy(x) for i, x in enumerate(leaves)})
    return path


def load_checkpoint(path: str, like: Any) -> Any:
    """Load a ``.npz`` checkpoint into the structure of ``like``."""
    leaves = _flatten(like, [])
    with np.load(path) as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, template has "
                f"{len(leaves)}")
        restored = []
        for i, leaf in enumerate(leaves):
            key = f"arr_{i}"
            if key not in data:
                raise ValueError(f"checkpoint is missing leaf {key}")
            a = data[key]
            if tuple(a.shape) != tuple(np.shape(leaf)):
                raise ValueError(
                    f"checkpoint leaf {i} has shape {tuple(a.shape)}, "
                    f"template expects {tuple(np.shape(leaf))}")
            restored.append(_restore(a, leaf))
    return _unflatten(like, iter(restored))
