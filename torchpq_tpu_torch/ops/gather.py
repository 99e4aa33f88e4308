"""Row gather: out[i] = table[clip(idx[i], 0, n - 1)].

Replaces the TPU kernel torchpq_tpu/ops/pallas_gather.py:gather_rows. The
kernel is `csrc/gather_rows.cu`, built by `_build.py` and bound through a
plain C entry point. It moves bytes, so any table dtype serves (f32, bf16,
int8 rows). The TPU kernel's table bound (`gather_rows_fits`, 8 MiB of
VMEM) has no counterpart here: the card reads rows straight from device
memory. The JAX package runs its kernel on no path; the port gathers the
rows of its compacted scan layouts with it (index/ivfpq.py:
_gather_compact), where the JAX package gathers in XLA.

What bounds it on an H100: bytes, the m gathered rows read once and written
once (plus the indices), at 3.35 TB/s. Each thread copies one 16-byte
vector of a row where the row width and the addresses allow it.

`gather_rows` takes the plain version `gather_rows_ref` only for tensors on
the CPU. For CUDA tensors it launches the kernel or raises.
"""

import ctypes

import torch

# kernel launches, counted by `gather_rows` where it launches
launches = {"gather": 0}


def gather_rows_ref(table, idx):
    """Plain PyTorch version of the kernel."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def _check(table, idx):
    if table.ndim != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous [n, d] tensor")
    if idx.ndim != 1 or idx.dtype not in (torch.int32, torch.int64) \
            or not idx.is_contiguous():
        raise TypeError("idx must be a contiguous int32 or int64 [m] tensor")
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")
    if table.shape[0] == 0 and idx.numel():
        raise ValueError("cannot gather rows of an empty table")


def gather_rows(table, idx):
    """table [n, d] (any dtype), idx [m] int32/int64 -> [m, d]; indices are
    clipped into [0, n - 1]."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_ref(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not "
                         f"{table.device}")
    from .. import _build
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = launch(_build.library(), stream, table, idx)
    launches["gather"] += 1
    return out


def launch(lib, stream, table, idx):
    """Launch the kernel of `lib` on `stream` with checked arguments;
    raises if the launch fails."""
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    row_bytes = table.shape[1] * table.element_size()
    if out.numel() == 0:
        return out
    rc = lib.torchpq_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        table.shape[0], row_bytes, int(idx.dtype == torch.int64),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{rc}")
    return out
