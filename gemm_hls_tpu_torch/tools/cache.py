"""Compiled-artifact packaging: the port of ``gemm_hls_tpu/tools/cache.py``
(the reference's ``build_manager.py package / unpackage``,
``scripts/build_manager.py:434-575``).

The reference's costly artifact is the FPGA bitstream, the JAX package's
XLA's compilation cache.  The port's is ``_build.py``'s kernel library: one
shared library of every ``csrc/`` kernel, built by ``nvcc`` at first use
and named by a hash of the sources and flags
(``libgemm_hls_kernels_<hash>.so``, beside its build log), in the
package's gitignored ``build/``.  This module points the build at another
directory for this process, and packages and unpackages that directory as
a tarball, so another machine with the same sources loads the library with
no ``nvcc``.  A library whose hash does not match the sources is never
loaded: the hash is part of its name, so the sources build anew beside it.

    from gemm_hls_tpu_torch.tools.cache import enable_persistent_cache, package
    enable_persistent_cache("/path/to/cache")
    ... run / tune / sweep (the first kernel call builds into it) ...
    package("kernels_h100.tar.gz")
"""

from __future__ import annotations

import os
import tarfile
from pathlib import Path
from typing import Optional

from gemm_hls_tpu_torch import _build

DEFAULT_CACHE_DIR = os.path.expanduser("~/.cache/gemm_hls_tpu_torch/kernels")

_enabled_dir: Optional[str] = None


def enable_persistent_cache(cache_dir: Optional[str] = None,
                            min_compile_time_secs: float = 1.0) -> str:
    """Build and load the kernel library in ``cache_dir`` (default
    ``DEFAULT_CACHE_DIR``) for this process.  Call it before the first
    kernel launch: a library already loaded stays loaded.
    ``min_compile_time_secs`` is accepted for the reference's signature and
    unused: the one library is always kept."""
    global _enabled_dir
    del min_compile_time_secs
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    Path(cache_dir).mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = Path(cache_dir)
    _enabled_dir = cache_dir
    return cache_dir


def cache_dir() -> Optional[str]:
    return _enabled_dir


def package(archive_path: str, cache_dir_: Optional[str] = None) -> str:
    """Tar the build directory (default: the one this process builds into)
    for another machine (``build_manager.py package``)."""
    d = Path(cache_dir_ or _enabled_dir or _build.BUILD_DIR)
    if not d.is_dir():
        raise FileNotFoundError(f"no kernel build at {d}")
    with tarfile.open(archive_path, "w:gz", compresslevel=1) as tar:
        # recursive=False: rglob already lists every path.  A library
        # another process is still linking (*.tmp) is left out.
        for f in sorted(d.rglob("*")):
            if not f.name.endswith(".tmp"):
                tar.add(f, arcname=str(f.relative_to(d)), recursive=False)
    return archive_path


def unpackage(archive_path: str, cache_dir_: Optional[str] = None) -> str:
    """Extract a packaged build and build into it from now on
    (``build_manager.py unpackage``)."""
    d = Path(cache_dir_ or DEFAULT_CACHE_DIR)
    d.mkdir(parents=True, exist_ok=True)
    with tarfile.open(archive_path, "r:gz") as tar:
        tar.extractall(d, filter="data")
    return enable_persistent_cache(str(d))
