"""Build and load the port's CUDA kernels.

The sources in ``resolution_pde_tpu_torch/csrc`` are compiled with ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` per ``.cu`` file, all started
together, and linked into one shared library with a plain C interface,
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the library's entry points (argtypes, restype int)
_SIGNATURES = {
    "rpde_fused_ff_forward": [_I, _I, *[_P] * 9, _I, _L, _I, _P],
    "rpde_fused_ff_forward_route": [_I, _I, _I, _P, _I, _P],
    "rpde_fused_ff_backward": [_I, _I, *[_P] * 11, _I, _L, _I, _I, _P],
    "rpde_fused_ff_backward_slab": [_I, _P, _I, _I],
    "rpde_fused_ff_backward_tile_rows": [_I, _P, _I, _I],
    "rpde_spectral_pass": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L,
                           _L, _L, _L, _L, _L, _I, _P],
    "rpde_spectral_staged": [_I, *[_P] * 7, _I, _I, _I, _I, *[_L] * 8, _I, _P],
    "rpde_spectral_staged_fits": [_I, _I, _I, _I],
    "rpde_spectral_wgrad": [*[_P] * 8, _I, _I, _I, _I, *[_L] * 8, _I, _P],
    "rpde_spectral_wgrad_chunks": [_I, _I, _I, _I, _L],
    "rpde_vandermonde": [*[_P] * 5, _I, _I, _I, _P],
    "rpde_s4d_kernel": [*[_P] * 4, _I, _I, _I, _I, _P],
    "rpde_cauchy": [*[_P] * 8, _I, _I, _I, _P],
    "rpde_dplr_at_roots": [*[_P] * 6, _I, _I, _I, _I, _P],
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


def _run_all(cmds: list) -> None:
    """Run the commands at once; raise with every failure's output after
    all of them have ended."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def library_path() -> Path:
    """Path of the built library, compiling it first if it is missing."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"librpde_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [s for s in _sources() if s.suffix == ".cu"]
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in units]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                  for s, o in zip(units, objs)])
        lib = str(Path(tmp) / so.name)
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, so)  # atomic: a concurrent build never sees half a file
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
