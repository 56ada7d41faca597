"""Build and load the package's CUDA kernels.

Each source ``refiners_tpu_torch/csrc/*.cu`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface, loaded
with ``ctypes``. The ``nvcc`` processes run side by side. The libraries go to
``build/refiners_tpu_torch/`` at the root of the checkout, each named by a
hash of its source, the shared headers and the flags, so an edited source
rebuilds its own library (an edited header rebuilds all). Nothing is built
or loaded until the first kernel launch on a CUDA tensor.
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
from types import SimpleNamespace

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "refiners_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]  # fmt: skip

# the element types the kernels take, numbered as the C entry points take them:
# bfloat16 and float16 on tensor cores, float32 on FFMA
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

_P, _I, _LL, _ULL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_float
# C entry point → (source stem, argument types); every entry returns a cudaError_t as int
_ENTRIES = {
    "refiners_flash_attention_forward": (
        "flash_attention_forward",
        [_P] * 6 + [_I] * 6 + [ctypes.POINTER(_LL), _F, _I, _P],
    ),
    "refiners_flash_attention_forward_kernel": ("flash_attention_forward", [_I] * 2),
    "refiners_flash_attention_relpos_forward": (
        "flash_attention_forward",
        [_P] * 6 + [_I] * 8 + [ctypes.POINTER(_LL), _F, _P],
    ),
    "refiners_flash_attention_bwd_dkv": (
        "flash_attention_backward",
        [_P] * 9 + [_I] * 6 + [ctypes.POINTER(_LL), _F, _I, _P],
    ),
    "refiners_flash_attention_bwd_dq": (
        "flash_attention_backward",
        [_P] * 9 + [_I] * 6 + [ctypes.POINTER(_LL), _F, _I, _P],
    ),
    "refiners_group_norm_stats": ("group_norm", [_P, _P, _I, _LL, _LL, _I, _I, _P]),
    "refiners_group_norm_apply": (
        "group_norm",
        [_P] * 5 + [_I, _I, _LL, _I, _LL, _LL, _I, _I, _I, _F, _I, _P],
    ),
    "refiners_quantize_int8": ("quant", [_P] * 3 + [_I] * 4 + [_LL, _I, _ULL, _P]),
    "refiners_lora_down": (
        "lora",
        [_P, _LL, _I, _LL, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_F), _P, _I, _P],
    ),
    "refiners_lora_up_add": ("lora", [_P, _LL, _I, _I, _I, _P, _I, ctypes.POINTER(_P), ctypes.POINTER(_I), _P]),
}


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


def library_paths() -> dict[str, Path]:
    """Source stem → the path of its library, tagged by a hash of the flags,
    the source and the shared headers."""
    headers = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        headers.update(header.name.encode() + header.read_bytes())
    paths = {}
    for src in _sources():
        tag = hashlib.sha256(headers.digest() + src.read_bytes()).hexdigest()[:16]
        paths[src.stem] = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    return paths


def build_libraries() -> tuple[dict[str, Path], str]:
    """Compile every missing library, one ``nvcc`` per source, all at once;
    return the paths and the compilers' output (empty when nothing was
    compiled)."""
    paths = library_paths()
    missing = {stem: path for stem, path in paths.items() if not path.exists()}
    if not missing:
        return paths, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for stem, path in missing.items():
        # compile to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((path, tmp, cmd, proc))
    log, failures = [], []
    for path, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths, "".join(log)


@functools.cache
def load_library() -> SimpleNamespace:
    """Build if needed and load the kernels' libraries; the C entry points,
    typed, as attributes of the result."""
    paths, _ = build_libraries()
    libs = {stem: ctypes.CDLL(str(path)) for stem, path in paths.items()}
    entries = {}
    for name, (stem, argtypes) in _ENTRIES.items():
        fn = getattr(libs[stem], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entries[name] = fn
    return SimpleNamespace(**entries)


def c_longlongs(values: list[int]) -> ctypes.Array:
    """A C array of long long, for the entry points' stride arguments."""
    return (_LL * len(values))(*values)


def stream(x: torch.Tensor) -> int:
    """The handle of the current CUDA stream of x's device, for the entry points."""
    return torch.cuda.current_stream(x.device).cuda_stream
