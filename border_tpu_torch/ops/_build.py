"""Builds the port's CUDA sources into shared libraries at first use.

``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<digest>.so`` (the digest is of the source, so an edited
source builds anew) and loaded with ``ctypes``.  The sources expose a plain C
interface and include no PyTorch header, which keeps a build to seconds.
Nothing is built when the package is imported: the first wrapper call that
needs a library builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the port's CUDA kernels are built "
        "from source at first use"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing.
    Raises with the compiler's output if ``nvcc`` fails."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
        os.replace(tmp, path)  # atomic: no half-written library
    lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
