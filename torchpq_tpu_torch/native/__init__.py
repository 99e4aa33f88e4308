"""Native (C++) host-side data plane, loaded through ctypes (counterpart of
torchpq_tpu/native).

`src/native.cpp` (a copy of the JAX package's source) is built at first use
with one `g++ -O3 -shared -fPIC` into `build/torchpq_tpu_torch/` beside the
package, named by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once. It exposes the texmex
fvecs / bvecs / ivecs readers, `stream_vecs`, and the sequential greedy
spill assigner behind `IVFPQIndex.add` with `spill_impl="host"`.

Where no compiler is present the functions fall back to numpy, as the JAX
package's do, with the same results. The fallback is never silent: the
failed build warns once, and `LAST_ROUTE[name]` says which route ("cpp" or
"numpy") served the last call of each function.
"""

import ctypes
import hashlib
import os
import subprocess
import warnings
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "src" / "native.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

# function name -> "cpp" or "numpy": the route of its last call
LAST_ROUTE = {}
# why the C++ library is unavailable (None while it builds or loads)
BUILD_ERROR = None

_lib = None
_build_failed = False

_P = ctypes.c_void_p
_L = ctypes.c_int64
_I = ctypes.c_int32
_SIGNATURES = {
    "read_fvecs": ([ctypes.c_char_p, _L, _I, _P, _L], _L),
    "read_bvecs": ([ctypes.c_char_p, _L, _I, _P, _L], _L),
    "read_ivecs": ([ctypes.c_char_p, _L, _I, _P, _L], _L),
    "vecs_dim": ([ctypes.c_char_p], _I),
    "spill_assign": ([_P, _L, _I, _P, _L, _P], None),
}


def library_path():
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libtorchpq_native_{h.hexdigest()[:16]}.so"


def _build():
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: concurrent processes may build
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}): {res.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib():
    """The loaded library, or None (warned once) where it cannot be built."""
    global _lib, _build_failed, BUILD_ERROR
    if _lib is not None or _build_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError) as e:
        _build_failed = True
        BUILD_ERROR = f"{type(e).__name__}: {e}"
        warnings.warn("torchpq_tpu_torch.native: the C++ library is "
                      f"unavailable ({BUILD_ERROR}); numpy serves instead",
                      RuntimeWarning, stacklevel=3)
        return None
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return _lib


def _read_vecs(path, fn_name, dtype, n_max=None, offset=0):
    lib = _get_lib()
    LAST_ROUTE[fn_name] = "numpy" if lib is None else "cpp"
    if lib is None:
        return _read_vecs_numpy(path, dtype, n_max, offset)
    path_b = os.fspath(path).encode()
    d = lib.vecs_dim(path_b)
    if d <= 0:
        raise ValueError(f"cannot read {path}")
    row_bytes = 4 + d * np.dtype(dtype).itemsize
    n_file = os.path.getsize(path) // row_bytes
    if n_max is None:
        n_max = max(n_file - offset, 0)
    n_max = min(n_max, max(n_file - offset, 0))
    out = np.empty((n_max, d), dtype)
    n = getattr(lib, fn_name)(path_b, n_max, d, out.ctypes.data, offset)
    if n < 0:
        raise ValueError(f"malformed vecs file {path}")
    return out[:n]


def _read_vecs_numpy(path, dtype, n_max=None, offset=0):
    """The JAX package's numpy reader (torchpq_tpu/native:_read_vecs_numpy)."""
    with open(path, "rb") as f:
        d = int(np.frombuffer(f.read(4), np.int32)[0])
        itemsize = np.dtype(dtype).itemsize
        row = 4 + d * itemsize
        n = max(os.path.getsize(path) // row - offset, 0)
        if n_max is not None:
            n = min(n, n_max)
        f.seek(offset * row)
        raw = np.fromfile(f, dtype=np.uint8, count=n * row)
    body = raw.reshape(n, row)[:, 4:]
    return body.view(dtype).reshape(n, d).copy()


def read_fvecs(path, n_max=None, offset=0):
    """Read a texmex .fvecs file -> [n, d] float32 (SIFT1M/GIST1M format).
    `offset` skips that many rows first (rows are fixed-size), so files
    bigger than RAM stream in chunks: see stream_vecs."""
    return _read_vecs(path, "read_fvecs", np.float32, n_max, offset)


def read_bvecs(path, n_max=None, offset=0):
    """Read a texmex .bvecs file -> [n, d] uint8."""
    return _read_vecs(path, "read_bvecs", np.uint8, n_max, offset)


def read_ivecs(path, n_max=None, offset=0):
    """Read a texmex .ivecs file -> [n, d] int32 (ground-truth ids)."""
    return _read_vecs(path, "read_ivecs", np.int32, n_max, offset)


def stream_vecs(path, chunk_rows=250_000, n_max=None, kind="fvecs"):
    """Yield [chunk_rows, d] blocks of a texmex file: out-of-core ingest for
    datasets bigger than host RAM (e.g. bigann bvecs)."""
    reader = {"fvecs": read_fvecs, "bvecs": read_bvecs,
              "ivecs": read_ivecs}[kind]
    off = 0
    while n_max is None or off < n_max:
        want = chunk_rows if n_max is None else min(chunk_rows, n_max - off)
        block = reader(path, n_max=want, offset=off)
        if not len(block):
            return
        yield block
        off += len(block)


def _spill_assign_numpy(top, counts, cap):
    """The JAX package's numpy greedy (torchpq_tpu/native:spill_assign):
    each item in arrival order takes its first candidate below `cap`, else
    its least-occupied candidate (the first such on equal counts)."""
    out = np.empty(top.shape[0], np.int64)
    for i, row in enumerate(top):
        for c in row:
            if counts[c] < cap:
                break
        else:
            c = row[np.argmin(counts[row])]
        counts[c] += 1
        out[i] = c
    return out


def spill_assign(top, counts, cap):
    """Greedy capacity-bounded assignment. top: [n, l] int32 best-first
    candidate cells; counts: [n_cells] int64 occupancy (mutated in place
    where it is a contiguous int64 array); cap: int. Returns ([n] chosen
    cells int64, the updated counts)."""
    top = np.ascontiguousarray(top, np.int32)
    counts = np.ascontiguousarray(counts, np.int64)
    n, l = top.shape
    if n and (int(top.min()) < 0 or int(top.max()) >= counts.shape[0]):
        raise ValueError("spill_assign: candidate cells out of range")
    lib = _get_lib()
    LAST_ROUTE["spill_assign"] = "numpy" if lib is None else "cpp"
    if lib is None:
        return _spill_assign_numpy(top, counts, cap), counts
    out = np.empty(n, np.int64)
    lib.spill_assign(top.ctypes.data, n, l, counts.ctypes.data, int(cap),
                     out.ctypes.data)
    return out, counts
