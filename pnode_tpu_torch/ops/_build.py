"""Build the port's CUDA kernels with nvcc and load them with ctypes.

``pnode_tpu_torch/csrc/*.cu`` compile into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds, not minutes):
one nvcc per source, all started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<source>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/pnode_tpu_torch/<hash>.so <objs>

at first use, into ``build/pnode_tpu_torch/`` at the repository root, keyed
by a hash of the sources and flags so an edited source rebuilds. The
library is loaded with ``ctypes``; every device pointer and the stream are
passed as ``c_void_p``. A missing ``nvcc`` or a failed build raises: there
is no fallback. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pnode_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_S = ctypes.c_size_t
_PI = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)
_PD = ctypes.POINTER(ctypes.c_double)
_L = ctypes.c_longlong
_PL = ctypes.POINTER(ctypes.c_longlong)

# C entry points: name -> (restype, argtypes)
_SIGNATURES = {
    "pnode_error_string": (ctypes.c_char_p, [_I]),
    "pnode_mlp_fwd": (_I, [_P, _P, _P, _S, _I, _I, _PI, _PP, _PP, _I, _P]),
    "pnode_mlp_bwd": (_I, [_P, _P, _P, _P, _P, _S, _I, _I, _PI, _PP, _PP, _I,
                           _P]),
    "pnode_ark_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _PD, _PD, _D,
                           _F, _I, _PI, _PP, _PP, _I, _I, _P]),
    "pnode_ark_fwd_plan": (_I, [_I, _I, _I, _I, _PI, _PI, _PI, _PL]),
    "pnode_ark_adj": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _PD, _D,
                           _F, _I, _PI, _PP, _PP, _I, _I, _L, _P]),
    "pnode_ark_adj_plan": (_I, [_I, _I, _I, _I, _PI, _PI, _PI, _PL]),
    "pnode_train_loop": (_I, [_P] * 10 + [_I, _I, _I, _I, _PD, _D, _F, _I,
                                           _PI, _I, _I, _F, _D, _D, _D, _I,
                                           _L, _P]),
    "pnode_train_loop_plan": (_I, [_I, _I, _I, _I, _PI, _I, _PI, _PI, _PL]),
    "pnode_grad_step": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _PD, _D,
                             _F, _I, _PI, _I, _D, _I, _L, _P]),
    "pnode_grad_step_plan": (_I, [_I, _I, _I, _I, _PI, _PI, _PI, _PL]),
    "pnode_adaptive_loop": (_I, [_P] * 14 + [_I, _I, _I, _I, _PD, _PD, _D, _F,
                                             _I, _PI, _I, _I, _F, _D, _D, _D,
                                             _I, _D, _D, _D, _D, _D, _D, _D,
                                             _I, _L, _L, _P]),
    "pnode_adaptive_loop_plan": (_I, [_I, _I, _I, _I, _PI, _I, _I, _PI, _PI,
                                      _PL, _PL]),
    "pnode_sqnxt_fwd_plan": (_I, [_I, _PI, _I, _I, _I, _PI, _PL]),
    "pnode_sqnxt_fwd": (_I, [_P, _P, _I, _PI, _PP, _I, _I, _I, _P, _L, _I,
                             _P]),
    "pnode_sqnxt_fwd_layer": (_I, [_P, _P, _I, _PI, _PP, _I, _I, _I, _P, _L,
                                   _I, _P]),
    "pnode_sqnxt_bwd_plan": (_I, [_I, _PI, _I, _I, _I, _PI, _PL]),
    "pnode_sqnxt_bwd": (_I, [_P, _P, _P, _I, _PI, _PP, _I, _I, _I, _P, _L, _I,
                             _P]),
    "pnode_sqnxt_bwd_layer": (_I, [_P, _P, _P, _I, _PI, _PP, _I, _I, _I, _P,
                                   _L, _I, _P]),
    "pnode_stencil_fwd": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    "pnode_stencil_bwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P]),
    "pnode_smem_optin": (_I, [_PI]),
    "pnode_probe_smem": (_I, [_P, _P, ctypes.c_longlong, _I, _P]),
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from pnode_tpu_torch/csrc at first use")


def _build() -> Path:
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libpnode_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        cmds, objs, procs = [], [], []
        for src in sorted(CSRC.glob("*.cu")):
            objs.append(str(Path(work) / f"{src.stem}.o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
            cmds.append(cmd)
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        outs = [p.communicate()[0] for p in procs]
        log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
        for cmd, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
        tmp = str(Path(work) / "lib.so")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(link)}\n{log}")
        os.replace(tmp, lib_path)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(log)
    build_info.update(path=str(lib_path), seconds=seconds, cached=False,
                      log=log)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().pnode_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def int_array(values):
    return (ctypes.c_int * len(values))(*values)


def ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def double_array(values):
    return (ctypes.c_double * len(values))(*values)


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
