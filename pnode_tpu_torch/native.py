"""Build the shared C++ planners of ``csrc/`` with g++ and load them.

The checkpoint planners (``csrc/revolve.cpp``, ``csrc/cams.cpp``) are plain
C++ with a C interface, shared with the JAX package as source. The port
compiles them itself at first use::

    g++ -O2 -fPIC -shared -std=c++17 -o build/pnode_tpu_torch/lib<name>_<hash>.so \
        csrc/<name>.cpp

into ``build/pnode_tpu_torch/`` at the repository root, keyed by a hash of
the source and the flags (as ``ops/_build.py`` keys the CUDA library), and
loads the result with ``ctypes``. It never loads a library that the JAX
package built. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG.parent / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pnode_tpu_torch"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++, c++ or $CXX) on PATH: the "
                           "checkpoint planners are built from csrc/*.cpp")
    return cxx


def build(name: str) -> Path:
    """``csrc/<name>.cpp`` compiled to a shared library (cached by hash)."""
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    path = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = Path(work) / path.name
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp``, built on first call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
