"""Top-level distributed matmul: padding, algorithm dispatch, layout; the
port of ``gemm_hls_tpu/parallel/dispatch.py``.

Arbitrary global shapes are padded up to mesh-divisible sizes (K with the
semiring's absorbing pair, ``Semiring.absorbing_for``, so the padded terms
vanish under the reduce; M and N with the same values, sliced off after),
the requested algorithm runs on the padded operands, and the overhang is
sliced off the result.

Algorithms: ``"summa"`` (rectangular meshes, any semiring, transpose
flags), ``"cannon"`` (square meshes), ``"auto"`` (Cannon on a square mesh
without transposes, else SUMMA).
"""

from __future__ import annotations

from typing import Optional, Tuple

from gemm_hls_tpu_torch.config import GemmConfig, round_up
from gemm_hls_tpu_torch.ops.semiring import get_semiring
from gemm_hls_tpu_torch.parallel.mesh import Mesh
from gemm_hls_tpu_torch.parallel.sharding import (
    P, Sharded, _normalized, all_gather, device_put, global_tensor, map_shards, pad_to,
)
from gemm_hls_tpu_torch.parallel.summa import cannon_matmul, summa_matmul


def _slice_global(out: Sharded, m: int, n: int, axes) -> Sharded:
    """``out[:m, :n]`` laid out as GSPMD lays out the slice of a P(x, y)
    array: a dim the slice cuts is gathered over its axis and replicated
    (its spec entry None), an uncut dim keeps its split."""
    spec = list(axes)
    shards = out.shards
    for dim, size in enumerate((m, n)):
        if size < out.shape[dim]:
            shards = all_gather(shards, out.mesh, axes[dim], dim=dim)
            spec[dim] = None
    if spec == list(axes):
        return out
    rows = slice(0, m) if spec[0] is None else slice(None)
    cols = slice(0, n) if spec[1] is None else slice(None)
    shards = map_shards(lambda x: x[rows, cols], shards, mesh=out.mesh)
    return Sharded(out.mesh, _normalized(P(*spec)), (m, n), shards)


def _pad_for_mesh(a, b, sr, mp: int, kp: int, np_: int,
                  transpose_a: bool = False, transpose_b: bool = False):
    """A and B padded to (mp, kp) and (kp, np_) (their transposes under the
    flags): K with the semiring's absorbing pair, so the padded terms vanish
    under the reduce.  The M / N overhang is sliced off the output, so those
    pads only need to be inert along K; the absorbing values serve both."""
    k = a.shape[0] if transpose_a else a.shape[1]
    pads = sr.absorbing_for(a.dtype)
    if kp != k and pads is None:
        raise ValueError(
            f"K={k} is not divisible by the mesh and semiring "
            f"{sr.name!r} has no absorbing pad pair; pad K to {kp} yourself "
            f"or register `absorbing` for the semiring")
    pad_a, pad_b = pads if pads is not None else (0, 0)
    return (pad_to(a, (kp, mp) if transpose_a else (mp, kp), pad_a),
            pad_to(b, (np_, kp) if transpose_b else (kp, np_), pad_b))


def distributed_matmul(a, b, mesh: Mesh, *,
                       axes: Tuple[str, str] = ("x", "y"),
                       algorithm: str = "auto",
                       semiring="plus_times",
                       config: Optional[GemmConfig] = None,
                       out_dtype=None,
                       transpose_a: bool = False,
                       transpose_b: bool = False) -> Sharded:
    """C = op(A) . op(B) over a mesh of ranks, for arbitrary global shapes.

    Args:
      a: (M, K) global tensor or numpy array, or (K, M) with
        ``transpose_a``.
      b: (K, N), or (N, K) with ``transpose_b``.
      mesh: 2-D mesh; ``axes`` names its (row, column) axes.
      algorithm: "summa", "cannon", or "auto".
      semiring: any registered semiring.  A K that the mesh does not
        divide needs the semiring's absorbing pad pair (every built-in but
        ``max_times`` has one).

    Returns the (M, N) result as a :class:`Sharded`: P(x, y) where the mesh
    divides M and N, with a dim the final slice cuts replicated over its
    axis (JAX's layout of ``out[:m, :n]``).
    """
    sr = get_semiring(semiring)
    ax, ay = axes
    px, py = mesh.shape[ax], mesh.shape[ay]
    a, b = global_tensor(a), global_tensor(b)
    m, k = (a.shape[1], a.shape[0]) if transpose_a else tuple(a.shape)
    kb, n = (b.shape[1], b.shape[0]) if transpose_b else tuple(b.shape)
    if k != kb:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x {tuple(b.shape)}")

    if algorithm == "auto":
        algorithm = ("cannon" if px == py and not (transpose_a or transpose_b)
                     else "summa")
    if algorithm == "cannon":
        if px != py:
            raise ValueError(f"cannon needs a square mesh, got {px}x{py}")
        if transpose_a or transpose_b:
            raise ValueError("cannon path does not take transpose flags; "
                             "use algorithm='summa'")
        kp = round_up(k, px)
    elif algorithm == "summa":
        kp = round_up(k, px * py)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    a_p, b_p = _pad_for_mesh(a, b, sr, round_up(m, px), kp, round_up(n, py),
                             transpose_a, transpose_b)
    a_s = device_put(a_p, mesh, P(ay, ax) if transpose_a else P(ax, ay))
    b_s = device_put(b_p, mesh, P(ay, ax) if transpose_b else P(ax, ay))
    if algorithm == "cannon":
        out = cannon_matmul(a_s, b_s, mesh, axes=axes, semiring=sr,
                            config=config, out_dtype=out_dtype)
    else:
        out = summa_matmul(a_s, b_s, mesh, axes=axes, semiring=sr,
                           config=config, out_dtype=out_dtype,
                           transpose_a=transpose_a, transpose_b=transpose_b)
    return _slice_global(out, m, n, axes)
