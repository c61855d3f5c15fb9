"""Build and load the port's CUDA kernels.

The sources in ``resolution_pde_tpu_torch/csrc`` are compiled with ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with ``ctypes``. The library is built at first use, into
``build/kernels/`` beside the package, under a name keyed by a hash of the
sources, so an edited source is rebuilt and an unchanged one is not.
Nothing here runs when the module is imported.
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

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the library's entry points (argtypes, restype int)
_SIGNATURES = {
    "rpde_fused_ff_forward": [_I, _I, *[_P] * 9, _I, _L, _I, _P],
    "rpde_fused_ff_backward": [_I, _I, *[_P] * 11, _I, _L, _I, _I, _P],
    "rpde_spectral_pass": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                           _L, _L, _L, _L, _L, _L, _I, _P],
}


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on a machine with the CUDA toolkit")


def library_path() -> Path:
    """Path of the built library, compiling it first if it is missing."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"librpde_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(s) for s in _sources() if s.suffix == ".cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's C signature set."""
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
