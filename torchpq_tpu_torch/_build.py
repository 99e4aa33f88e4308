"""Build the package's CUDA kernels with nvcc and load them with ctypes.

All `csrc/*.cu` files compile into one shared library with a plain C
interface, for Hopper (`sm_90a`), at first use: one nvcc per source, all
started together, then one link (with libcuda, for the TMA tensor maps of
`csrc/block_scan_wg.cu` and `csrc/flat_scan_wg.cu`). The library goes to
`build/torchpq_tpu_torch/` beside the package, named by a hash of the
sources, the headers they share (`csrc/*.cuh`) and the flags, so an edited
file rebuilds and an unchanged tree loads at once. Nothing but the sources
in this package is compiled.
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
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
BUILD_DIR = _PKG.parent / "build" / "torchpq_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the link: libcuda, for the TMA tensor maps of block_scan_wg.cu and
# flat_scan_wg.cu
# (cuTensorMapEncodeTiled); nvcc links its stub, the loader the installed one
LINK_FLAGS = ["-lcuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# ctypes signatures of the C entry points (pointers as c_void_p, so a 64-bit
# device address is never cut to a 32-bit int)
_SIGNATURES = {
    "torchpq_block_scan": ([_P] * 8 + [_I] * 11 + [_P], _I),
    "torchpq_block_scan_smem": ([_I] * 5, _L),
    "torchpq_block_scan_int8": ([_P] * 10 + [_I] * 10 + [_P], _I),
    "torchpq_block_scan_int8_smem": ([_I] * 4, _L),
    "torchpq_block_scan_wg": ([_P] * 8 + [_I] * 11 + [_P], _I),
    "torchpq_block_scan_wg_instance": ([_P] * 8 + [_I] * 11 + [_P, _I], _I),
    "torchpq_block_scan_wg_smem": ([_I] * 3, _L),
    "torchpq_block_scan_wg_occupancy": ([_I] * 3, _I),
    "torchpq_block_scan_wg_int8": ([_P] * 10 + [_I] * 11 + [_P], _I),
    "torchpq_block_scan_wg_int8_instance": ([_P] * 10 + [_I] * 11
                                            + [_P, _I], _I),
    "torchpq_block_scan_wg_int8_smem": ([_I] * 3, _L),
    "torchpq_block_scan_wg_int8_occupancy": ([_I] * 3, _I),
    "torchpq_codes_scan": ([_P] * 9 + [_I] * 12 + [_P], _I),
    "torchpq_codes_scan_smem": ([_I] * 4, _L),
    "torchpq_codes_scan_wg": ([_P] * 9 + [_I] * 12 + [_P], _I),
    "torchpq_codes_scan_wg_smem": ([_I] * 4, _L),
    "torchpq_codes_scan_wg_occupancy": ([_I] * 4, _I),
    "torchpq_flat_scan": ([_P] * 7 + [_I] * 9 + [_P], _I),
    "torchpq_flat_scan_smem": ([_I] * 3, _L),
    "torchpq_flat_scan_tc": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "torchpq_flat_scan_tc_smem": ([_I] * 3, _L),
    "torchpq_flat_scan_tc_occupancy": ([_I] * 3, _I),
    "torchpq_flat_scan_wg": ([_P] * 8 + [_I] * 7 + [_P], _I),
    "torchpq_flat_scan_wg_smem": ([_I] * 2, _L),
    "torchpq_flat_scan_wg_occupancy": ([_I] * 2, _I),
    "torchpq_gather_rows": ([_P] * 3 + [_L] * 3 + [_I, _P], _I),
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
    Returns (path, seconds spent compiling, compiler log); the log is kept
    beside the library, so a process that finds it built reads the same
    ptxas report."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libtorchpq_kernels_{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [(src.name, p.returncode, text) for src, p, text
              in zip(SOURCES, procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{text}" for name, rc, text in failed))
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs),
                          *LINK_FLAGS], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({res.returncode}):\n{res.stdout}\n"
            f"{res.stderr}")
    log += res.stdout + res.stderr
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, seconds, log


def library():
    """The kernel library, built and loaded once per process."""
    global _library
    if _library is None:
        path, seconds, log = build()
        _library = Library(path, seconds, log)
    return _library
