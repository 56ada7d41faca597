"""Build and load the package's CUDA kernels.

The sources under ``refiners_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``. The library goes to ``build/refiners_tpu_torch/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited source
rebuilds. Nothing is built or loaded until the first kernel launch on a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "refiners_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]  # fmt: skip


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (nvcc on PATH or /usr/local/cuda)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"librefiners_kernels_{digest.hexdigest()[:16]}.so"


def build_library() -> tuple[Path, str]:
    """Compile the kernels if their library is missing; return its path and
    the compiler's output (empty when nothing was compiled)."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels' library, with typed entry points."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    fn = lib.refiners_flash_attention_packed
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib
