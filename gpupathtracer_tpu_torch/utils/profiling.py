"""Tracing and timing hooks.

Counterpart of ``gpupathtracer_tpu/utils/profiling.py``:

- ``trace(dir)``: ``torch.profiler`` around any render (host ops, and the
  card's kernels when CUDA is initialised), written as a Chrome trace
  ``trace.json`` into ``dir``; the CLI's ``--profile-dir``.
- ``scope(name, *args)``: a named span, a ``record_function`` user
  annotation on the profiler's own clock, with ``args`` (ints) as its
  recorded inputs.
- ``frame(seed, device)``: what ``render_frame`` records of each frame.
- ``frame_records()``: those records, the one place that reads the frames'
  counters back.
- ``force(x)``: waits for ``x`` by reading one of its values.
- ``Timer``: wall clock and rays/s; ``stop`` synchronises the card first.

Tracing is on exactly while a ``torch.profiler`` profile records (the
profiler's own flag, read at every span): there is no other switch. With
no profiler running a span costs a flag check and opens nothing, and a
frame allocates no counter.

The spans of the render path, as ``trace.json`` shows them (each nested in
the one it names; a span's device time includes its children's):

- ``render.frame``: one ``render_frame`` call; its recorded input is the
  frame's seed (``trace`` records inputs), which identifies the spans of one
  frame;
- ``render.bounce``: one bounce of ``trace_paths``, in ``render.frame``;
- ``render.compact``: compaction, the coherent sort and the inverse
  permutation around a search, in a bounce (or around the later bounces
  for ``compact_mode="hybrid"``);
- ``render.schedule``: ray features, tile culling and the block or cluster
  schedule of a search, and the straggler regroup's schedule;
- ``render.search.closest``: the closest-hit launch or launches and the
  hits they give;
- ``render.search.any``: the any-hit launch;
- ``render.shade``: hit attributes, materials, emission, next-event
  estimation (its shadow rays' spans inside), scatter and roulette, in a
  bounce;
- ``render.rng``: a path sampler's key, fold or uniform draw, in a frame or
  in ``render.shade``.

A traced frame also carries a test counter (``frame_tests``): the closest-
hit searches add the (live lane, triangle column) tests they computed to it
on the device, and nothing is read back during the frame.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# The newest frames whose records frame_records() returns, of each kind:
# untraced and traced (a traced frame's record outlives the untraced frames
# after it). A benchmark window renders some 200-550 frames, and its metrics
# compare the records with every untraced frame of the window.
FRAME_RING = 1024


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(profile_dir: str | None):
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    # record_shapes keeps the spans' inputs: render.frame's seed.
    with profile(activities=activities, record_shapes=True) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def tracing() -> bool:
    """Whether a ``torch.profiler`` profile is recording."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name, *self.args)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)


_OFF = contextlib.nullcontext()


def scope(name: str, *args):
    """A span named ``name`` while a profiler records (``args``, ints, are
    its recorded inputs); otherwise a context that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


@dataclasses.dataclass
class _Frame:
    seed: int
    start_s: float  # time.perf_counter() at render_frame's entry
    end_s: float = float("nan")  # and at its return
    tests: torch.Tensor | None = None  # traced frames: the test counter, int64 (1,)


_frames = collections.deque(maxlen=FRAME_RING)
_traced_frames = collections.deque(maxlen=FRAME_RING)
_active = threading.local()  # .frame: the frame being rendered on this thread


@contextlib.contextmanager
def frame(seed: int, device):
    """One ``render_frame`` call: the ``render.frame`` span with the seed,
    and a record of its host start and return (always: two clock reads),
    kept among the newest ``FRAME_RING`` of its kind. A traced frame also
    gets its test counter on ``device``, zeroed by one fill, which
    ``frame_tests`` hands to the searches."""
    rec = _Frame(seed=int(seed), start_s=time.perf_counter())
    if tracing():
        rec.tests = torch.zeros(1, dtype=torch.int64, device=device)
    outer = getattr(_active, "frame", None)
    _active.frame = rec
    try:
        with scope("render.frame", rec.seed):
            yield
    finally:
        _active.frame = outer
    rec.end_s = time.perf_counter()
    (_frames if rec.tests is None else _traced_frames).append(rec)


def frame_tests() -> torch.Tensor | None:
    """The test counter of the traced frame being rendered on this thread:
    an int64 tensor of one element on the frame's device, to which the
    closest-hit searches add the (live lane, triangle column) tests they
    compute; None outside a traced frame."""
    rec = getattr(_active, "frame", None)
    return None if rec is None else rec.tests


def frame_records() -> list[dict]:
    """The records of the newest ``FRAME_RING`` untraced and the newest
    ``FRAME_RING`` traced frames, oldest first: ``seed``, ``start_s`` and
    ``end_s`` (``time.perf_counter()`` at ``render_frame``'s entry and
    return), and ``tests``, the frame's test count (None for an untraced
    frame). Reading a count waits for its frame's device work: call this
    after the frames, not inside one."""
    records = sorted([*_frames, *_traced_frames], key=lambda r: r.start_s)
    return [{"seed": r.seed, "start_s": r.start_s, "end_s": r.end_s,
             "tests": None if r.tests is None else int(r.tests.item())} for r in records]


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
