"""Tracing / profiling helpers (counterpart of torchpq_tpu/profiling.py).

Reference counterpart: a wall-clock `tick()` probe with device sync
(torchpq/util.py:86-99) and external Nsight profiling (profile.sh). Here:
named scopes that show up in torch.profiler traces (and as NVTX ranges on
the card, for Nsight), a `trace()` context manager writing a Chrome trace,
and a structured phase timer that synchronizes the card at its boundaries.
"""

import contextlib
import os
import time

import torch

from .util import block_until_ready


def _cuda_in_use():
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def named_scope(name):
    """Annotate a region so it appears in profiler traces: a
    torch.profiler.record_function, plus an NVTX range on the card."""
    nvtx = _cuda_in_use()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir):
    """Profile the region (host ops, and the card's kernels where there is
    one) and write a Chrome trace (chrome://tracing, Perfetto) into
    `log_dir` as `torchpq_trace.<pid>.<ns>.json`. Yields the
    torch.profiler.profile object; its `trace_path` attribute names the
    file once the region has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = None
    with prof:
        yield prof
        if _cuda_in_use():
            torch.cuda.synchronize()
    path = os.path.join(
        log_dir, f"torchpq_trace.{os.getpid()}.{time.monotonic_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


class PhaseTimer:
    """Structured multi-phase wall timer with device sync at boundaries
    (generalizes the reference's tick())."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name, sync=None):
        """Time the region into phases[name] (summed over repeats). The
        current CUDA device (where one is in use) is synchronized at both
        boundaries; `sync`, a zero-argument callable returning the phase's
        output tensors, has their devices waited for at the end too."""
        if _cuda_in_use():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if sync is not None:
            block_until_ready(sync())
        if _cuda_in_use():
            torch.cuda.synchronize()
        self.phases[name] = self.phases.get(name, 0.0) + (
            time.perf_counter() - t0)

    def report(self):
        return dict(sorted(self.phases.items(), key=lambda kv: -kv[1]))
