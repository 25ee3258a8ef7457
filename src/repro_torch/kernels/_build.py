"""Build and load the port's CUDA kernels (``csrc/*.cu``): the macro ops
and megakernels, the MHT panel kernel and the WY trailing kernel.

``nvcc`` compiles each source into an object, all at once in parallel
processes, and links them into one shared library with a plain C
interface, loaded with ``ctypes``; no PyTorch headers are involved, so a
build takes seconds.  The library lands in ``build/repro_torch_kernels/
<hash>/`` at the repository root, keyed on a hash of every file in
``csrc/`` and the flags, and is built on first use: :func:`library` is
called by the first kernel launch, never at import.  A failed build (no
``nvcc``, a compiler error, a library that does not load) raises
:class:`BuildError`, which the escalation ladder re-raises instead of
degrading past the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BuildError", "library", "build", "error_string", "NVCC_FLAGS",
           "LINK_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared", "-Xcompiler", "-fPIC")

# (ws, aux0, aux1, idx, ntasks, batch, p, q, nb, is_double, smem_bytes,
#  stream)
_MACRO_OP_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# (kind, ws, aux, e, idx, ntasks, batch, p, q, qe, nb, stages, is_double,
#  smem_bytes, stream, grid_out)
_WALK_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
# (ws, d_t, d_taus, t_t, t_taus, e, table, runs, nlevels, nslots, batch,
#  p, q, qe, nb, stages, grid, is_double, smem_bytes, barrier, stream,
#  grid_out)
_MEGAKERNEL_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 \
    + [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int)]
# (batched, q, is_double, smem_bytes, per_sm_out, resident_out)
_MEGAKERNEL_RESIDENT_ARGS = [ctypes.c_int] * 4 \
    + [ctypes.POINTER(ctypes.c_int)] * 2
# (a, a_bs, lda, m, b, kf, taus, batch, groups, rows, part, barriers,
#  is_double, smem_bytes, stream, grid_out)
_MHT_PANEL_ARGS = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
# (a, a_bs, lda, m, b, kf, taus, batch, cluster, rows, is_double,
#  smem_bytes, stream, grid_out)
_MHT_PANEL_CLUSTER_ARGS = [ctypes.c_void_p, ctypes.c_longlong] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
# (v, v_bs, ldv, t, c, c_bs, ldc, m, n, k, batch, part, barriers,
#  is_double, smem_bytes, stream, grid_out, splits_out)
_WY_TRAILING_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
    + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 2
# (v, v_bs, ldv, t, c, c_bs, ldc, m, n, k, batch, cluster, rows,
#  is_double, smem_bytes, stream, grid_out)
_WY_TRAILING_CLUSTER_ARGS = [ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int] + [ctypes.c_void_p] * 2 \
    + [ctypes.c_longlong] + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
_ENTRIES = {
    "repro_geqrt": _MACRO_OP_ARGS,
    "repro_tsqrt": _MACRO_OP_ARGS,
    "repro_walk": _WALK_ARGS,
    "repro_megakernel": _MEGAKERNEL_ARGS,
    "repro_megakernel_batched": _MEGAKERNEL_ARGS,
    "repro_megakernel_resident": _MEGAKERNEL_RESIDENT_ARGS,
    "repro_mht_panel": _MHT_PANEL_ARGS,
    "repro_mht_panel_cluster": _MHT_PANEL_CLUSTER_ARGS,
    "repro_wy_trailing": _WY_TRAILING_ARGS,
    "repro_wy_trailing_cluster": _WY_TRAILING_CLUSTER_ARGS,
}
_LIB = None


class BuildError(RuntimeError):
    """The kernel library could not be built or loaded."""


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
        raise BuildError("nvcc not found: the kernels are built from csrc/ "
                           "with the CUDA toolkit")
    return found


def _sources():
    """Every file in ``csrc/``: the hash covers headers too."""
    return sorted(p for p in _CSRC.iterdir() if p.is_file())


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd, what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed on {what} ({proc.returncode}):\n{out}")
    return out


def build() -> Path:
    """Compile the kernels if this source hash has no library yet;
    return the library's path."""
    global BUILD_LOG
    out_dir = _BUILD_ROOT / _digest()
    lib = out_dir / "libkernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    units = [p for p in _sources() if p.suffix == ".cu"]
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in units]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for p, o in zip(units, objs)]
    logs, failed = [], []
    for p, proc in zip(units, procs):
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{p.name} ({proc.returncode}):\n{out}")
    BUILD_LOG = "".join(logs)
    if failed:
        raise BuildError("nvcc failed on " + "\n".join(failed))
    tmp = out_dir / f"libkernels.{tag}.so"
    BUILD_LOG += _run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                      "the link")
    for o in objs:
        o.unlink()
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise BuildError(f"the kernel library {path} does not load: "
                             f"{e}") from e
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
