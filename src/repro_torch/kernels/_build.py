"""Build and load the macro-op kernels and the megakernel
(``csrc/macro_ops.cu``).

``nvcc`` compiles the sources into a shared library with a plain C
interface, loaded with ``ctypes``; no PyTorch headers are involved, so a
build takes seconds.  The library lands in ``build/repro_torch_kernels/
<hash>/`` at the repository root, keyed on a hash of the sources and the
flags, and is built on first use: :func:`library` is called by the first
kernel launch, never at import.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "build", "error_string", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("macro_ops.cu", "macro_ops.cuh")
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (ws, aux0, aux1, idx, ntasks, p, q, nb, is_double, smem_bytes, stream)
_MACRO_OP_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# (ws, d_t, d_taus, t_t, t_taus, table, nlevels, nslots, batch, p, q, nb,
#  is_double, smem_bytes, barrier, stream, grid_out)
_MEGAKERNEL_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int)]
_ENTRIES = {
    "repro_geqrt": _MACRO_OP_ARGS,
    "repro_larfb": _MACRO_OP_ARGS,
    "repro_tsqrt": _MACRO_OP_ARGS,
    "repro_ssrfb": _MACRO_OP_ARGS,
    "repro_megakernel": _MEGAKERNEL_ARGS,
    "repro_megakernel_batched": _MEGAKERNEL_ARGS,
}
_LIB = None
#: The compiler's output of the build that produced the loaded library
#: (``-Xptxas -v``: registers, shared memory and spills per kernel).
BUILD_LOG = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the macro-op kernels are built "
                           "from csrc/ with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet;
    return the library's path."""
    global BUILD_LOG
    out_dir = _BUILD_ROOT / _digest()
    lib = out_dir / "libmacro_ops.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libmacro_ops.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / "macro_ops.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def error_string(code: int) -> str:
    return library().repro_error_string(int(code)).decode()
