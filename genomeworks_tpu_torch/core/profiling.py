"""Tracing and profiling: the reference's NVTX layer, on ``torch.cuda.nvtx``.

The reference wraps every hot phase in ``GW_NVTX_RANGE`` RAII ranges
behind the ``gw_profiling`` CMake flag (common/base/include/.../
cudautils.hpp:161-176; dense usage e.g. cudamapper/src/main.cu:215,
index_gpu.cuh:822+). Counterpart of genomeworks_tpu/core/profiling.py:

- :func:`annotate`: a context manager that opens an NVTX range named after
  the phase (when a CUDA card is present) and adds the phase's host wall
  time to a process-wide table;
- :func:`phase_times` / :func:`reset_phase_times`: the accumulated wall
  time and call count of each phase;
- :func:`trace`: a ``torch.profiler`` trace (Chrome format) of the block,
  taken when ``GW_PROFILE=1`` or a directory is given, so that production
  runs pay nothing.

Wall times include host time between launches, and no phase synchronises
the device: a phase that reads a count back waits for the work before it,
one that does not ends before its kernels do. For device time, take a trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import threading
import time

import torch

_lock = threading.Lock()
_times: dict[str, float] = collections.defaultdict(float)
_counts: dict[str, int] = collections.defaultdict(int)


@contextlib.contextmanager
def annotate(name: str):
    """Name a phase: an NVTX range ``name`` around it on the card, and its
    host wall time added under ``name``. The mapper's index builds run on a
    worker thread beside the main thread's phases, so the table is locked."""
    t0 = time.perf_counter()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    with _lock:
        _times[name] += time.perf_counter() - t0
        _counts[name] += 1


def phase_times() -> dict[str, dict[str, float]]:
    with _lock:
        return {
            k: {"seconds": round(_times[k], 4), "calls": _counts[k]}
            for k in sorted(_times)
        }


def reset_phase_times() -> None:
    with _lock:
        _times.clear()
        _counts.clear()


@contextlib.contextmanager
def trace(trace_dir: str | None = None):
    """Write a ``torch.profiler`` trace of the block to ``trace_dir`` when
    GW_PROFILE=1 or a directory is given explicitly; no-op otherwise. The
    default directory is ``GW_PROFILE_DIR``, else ``gw_trace`` in the
    temporary directory."""
    explicit = trace_dir is not None
    if not explicit and os.environ.get("GW_PROFILE") != "1":
        yield
        return
    trace_dir = trace_dir or os.environ.get(
        "GW_PROFILE_DIR", os.path.join(tempfile.gettempdir(), "gw_trace"))
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
