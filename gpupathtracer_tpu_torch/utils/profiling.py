"""Tracing and timing hooks.

Counterpart of ``gpupathtracer_tpu/utils/profiling.py``:

- ``trace(dir)``: ``torch.profiler`` around any render (host ops, and the
  card's kernels when CUDA is initialised), written as a Chrome trace
  ``trace.json`` into ``dir``; the CLI's ``--profile-dir``.
- ``scope(name)``: a named range, ``record_function`` in the profiler and
  an NVTX range on the card.
- ``force(x)``: waits for ``x`` by reading one of its values.
- ``Timer``: wall clock and rays/s; ``stop`` synchronises the card first.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(profile_dir: str | None):
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


@contextlib.contextmanager
def scope(name: str):
    with torch.profiler.record_function(name):
        nvtx = _cuda_in_use()
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def force(x) -> float:
    """Wait for ``x`` (a tensor, or a tuple or list whose first element is
    one) by reading its first value; returns that value."""
    if isinstance(x, (tuple, list)):
        x = x[0]
    return float(x.detach().reshape(-1)[0])


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def stop(self, rays: int | None = None) -> dict:
        """Seconds since the timer started (after the card, if in use,
        finished its queued work), and ``rays_per_sec`` given ``rays``."""
        if _cuda_in_use():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self.t0
        out = {"seconds": round(dt, 4)}
        if rays:
            out["rays_per_sec"] = round(rays / max(dt, 1e-9), 1)
        return out
