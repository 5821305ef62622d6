"""Profiling helpers (port of `robust_nonlinear_mpc_tpu/utils/timing.py`).

  * `trace` - a `torch.profiler` window around the enclosed block (CPU and,
    when a card is present, CUDA activity), exported as a Chrome trace
    viewable in Perfetto; the counterpart of the JAX package's
    `jax.profiler` trace,
  * `timed` - the median wall clock of a call, with the card synchronized
    around every repetition (the counterpart of `block_until_ready`).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str = "build/rnm_trace"):
    """Profile the enclosed block; yields the profiler and writes
    `log_dir/trace.json` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed(fn, *args, reps: int = 10, warmup: int = 1):
    """Median wall clock of fn(*args), the card synchronized before and
    after every call. Returns (result, seconds_per_call)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return out, times[len(times) // 2]
