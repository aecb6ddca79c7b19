"""Build-cache location (≙ border_tpu/utils/cache.py).

The JAX package points XLA's persistent compilation cache at a directory
of the checkout.  The port's compiled programs are the native libraries
that :mod:`border_tpu_torch.ops._build` builds at first use (the CUDA
kernels with ``nvcc``, the C++ host envs with the host compiler), cached by
the digest of their source; this module says where that cache lives.  The
port uses neither ``torch.compile`` nor its inductor cache.
"""

from __future__ import annotations

import os
from pathlib import Path


def enable_compilation_cache(subdir: str = "border_tpu_torch/_build") -> str:
    """Point the native build cache at ``<root>/<subdir>`` and return it,
    created.  ``<root>`` is ``$BORDER_TPU_CACHE_DIR``, else the checkout
    that holds this package, so the default call leaves the cache where it
    is.  Call before the first kernel or host env is built."""
    from border_tpu_torch.ops import _build

    root = os.environ.get("BORDER_TPU_CACHE_DIR")
    if root is None:
        # <repo>/border_tpu_torch/utils/cache.py → <repo>
        root = str(Path(__file__).resolve().parents[2])
    path = os.path.join(root, subdir)
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    return path
