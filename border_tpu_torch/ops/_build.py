"""Builds the port's native sources into shared libraries at first use.

Two routes, one cache:

- ``csrc/<name>.cu`` (the CUDA kernels) is compiled by ``nvcc`` for
  ``sm_90a`` into ``_build/lib<name>-<digest>.so``.  The sources expose a
  plain C interface and include no PyTorch header, which keeps a build to
  seconds.
- ``cpp/<name>.cpp`` at the repository's root (the C++ host envs shared
  with the JAX package) is compiled by the host compiler (``$CXX``, else
  ``g++``) with exactly ``cpp/Makefile``'s flags into the same directory.
  The JAX package's committed ``cpp/libenvpool.so`` is never loaded or
  rebuilt: it was built with ``-march=native`` on another host.

The digest is of the source, so an edited source builds anew; a build
writes a temporary file and renames it, so processes building at once never
load a half-written library.  Each library is loaded with ``ctypes``.
Nothing is built when the package is imported: the first caller that needs
a library builds or loads it, in the span ``ops.build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

from border_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
CPP_SRC = Path(__file__).resolve().parents[2] / "cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# cpp/Makefile's CXXFLAGS and its -shared: -march=native lets the compiler
# contract float multiply-adds, so other flags give the envs other floats
# than the JAX package's library
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-pthread", "-shared")

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


def cxx() -> str:
    """The host compiler: ``$CXX``, else ``g++`` on the path."""
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"host C++ compiler {name!r} not found (set CXX); the port's host "
            f"envs are built from cpp/ at first use"
        )
    return found


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CPP_SRC / f"{name}.cpp"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(_source(name).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str, source: Path, command: Sequence[str]) -> Path:
    """Run ``command + [-o tmp, source]`` unless the library exists; rename
    the output into place.  Raises with the compiler's output on failure."""
    path = library_path(name)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [*command, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(command[0]).name} failed for {source.name}:\n{proc.stdout}")
        os.replace(tmp, path)  # atomic: no half-written library
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (nvcc) or of
    ``cpp/<name>.cpp`` (the host compiler), built first if missing."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with profiling.span("ops.build", tag=name):
        source = _source(name)
        if source.suffix == ".cu":
            path = _compile(name, source, [_nvcc(), *NVCC_FLAGS])
        else:
            path = _compile(name, source, [cxx(), *CXX_FLAGS])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
