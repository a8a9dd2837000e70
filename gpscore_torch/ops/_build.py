"""Build and load the CUDA C++ kernels of ``gpscore_torch/csrc/``.

The sources are compiled at first use with ``nvcc`` into a shared library with
a plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> gpscore_torch/csrc/*.cu

The library lands in ``build/gpscore_torch/`` at the repository root, named by
a hash of the sources and flags, so an edited source builds anew and an
unchanged one is built once. ``nvcc``'s report (``-Xptxas -v``: registers,
shared memory and spills of every kernel) is kept beside it as ``<lib>.log``.

Nothing here runs on import: the CPU tests import every module, and the CPU
has no ``nvcc``. A build that fails raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "gpscore_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argument types (pointers and the stream as void*): the
# pointers, the shape and the plan's ints, then the batch count and one batch
# stride (elements) per array.
SIGNATURES = {
    "gram_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _P],
    "gram_bwd_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _L, _L, _L, _L, _L, _L, _P],
    "gram_bwd_cols": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _P],
    # The d-chunked backward: cols and wide first, then as gram_bwd_rows with
    # the plan (tx, ty, chunk, groups, group width, threads).
    "gram_bwd_dchunk": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _L, _L, _L, _L, _L, _L, _P],
}
# The fp64 entry points take the same arguments as their fp32 namesakes.
SIGNATURES.update({f"{name}_f64": args for name, args in list(SIGNATURES.items())})

_loaded = {}  # "lib" -> ctypes.CDLL, "path" -> Path


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the gpscore_torch "
        "CUDA kernels cannot be built"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgpscore_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name, then rename: a concurrent build never sees a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    Path(f"{lib}.log").write_text(log)
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry point."""
    if "lib" not in _loaded:
        path = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded.update(lib=lib, path=path)
    return _loaded["lib"]


def build_report() -> str:
    """nvcc's output for the loaded library (ptxas register/spill lines)."""
    load_library()
    log = Path(f"{_loaded['path']}.log")
    return log.read_text() if log.exists() else ""
