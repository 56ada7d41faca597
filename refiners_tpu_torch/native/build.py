"""Build native (C++) components on demand: compile a ``.cpp`` of this
package with ``g++`` and load it with ``ctypes``.

Libraries go to ``build/refiners_tpu_torch/native/`` at the root of the
checkout, named by a hash of their source; each is compiled to a private
name and renamed, so processes that build at once never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "refiners_tpu_torch" / "native"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def library_path(name: str) -> Path:
    """Where `<name>.cpp`'s library is, or will be, built."""
    digest = hashlib.sha256((_SRC_DIR / f"{name}.cpp").read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load_library(name: str) -> ctypes.CDLL | None:
    """Compile `<name>.cpp` if needed and load it; None when there is no
    C++ compiler or the build fails."""
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *CXX_FLAGS, str(_SRC_DIR / f"{name}.cpp"), "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            os.unlink(tmp)
            return None
        os.replace(tmp, out)
    try:
        return ctypes.CDLL(str(out))
    except OSError:
        return None
