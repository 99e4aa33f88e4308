"""Build the package's CUDA kernels with nvcc and load them with ctypes.

All `csrc/*.cu` files compile into one shared library with a plain C
interface, for Hopper (`sm_90a`), at first use. The library goes to
`build/torchpq_tpu_torch/` beside the package, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
at once. Nothing but the sources in this package is compiled.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
BUILD_DIR = _PKG.parent / "build" / "torchpq_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# ctypes signatures of the C entry points (pointers as c_void_p, so a 64-bit
# device address is never cut to a 32-bit int)
_SIGNATURES = {
    "torchpq_block_scan": ([_P] * 8 + [_I] * 11 + [_P], _I),
    "torchpq_block_scan_smem": ([_I] * 5, ctypes.c_longlong),
}


class Library:
    """The loaded kernel library, with what its build printed."""

    def __init__(self, path, build_seconds, build_log):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.cdll = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = restype

    def __getattr__(self, name):
        return getattr(self.cdll, name)


_library = None


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(nvcc on PATH or under /usr/local/cuda/bin)")
    return path


def build():
    """Compile the sources if no library for their hash exists yet.
    Returns (path, seconds spent compiling, compiler log)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libtorchpq_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, seconds, res.stdout + res.stderr


def library():
    """The kernel library, built and loaded once per process."""
    global _library
    if _library is None:
        path, seconds, log = build()
        _library = Library(path, seconds, log)
    return _library
