"""The general generator: what every loop kind shares.

A traffic file (``traffic/<name>.json``) names its loop kind, ``"loop"``,
and that kind's parameters; the kind is ``loops/<loop>.py``, which builds
its ``Loop`` on ``Program`` here. Shared by every kind: ``spp``, the
samples a pixel of each item; ``traced_items``, the whole items profiled in
a ``--trace 1`` run; ``work_rays``, how many live rays of each bounce of
each checked sample the reference counts box crossings of (the roofline's
work).

Every time here is the host's clock around work that ends in a
synchronisation of the device. The rays of a frame or step are
W x H x spp x bounces.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import time
import zlib

import numpy as np
import torch

from h100_bench import devtrace

TRACE_START = 2  # the traced items start after this many items of the window


def seed_stream(seed: int, name: str) -> np.random.Generator:
    """An independent stream of the run's seed for one purpose."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), zlib.crc32(name.encode())])


def draw_seed(rng: np.random.Generator) -> int:
    return int(rng.integers(0, 2 ** 32))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    loop: str  # the loop kind, ``loops/<loop>.py``
    setup_s: float
    starts: list  # host seconds, each item of the window
    ends: list
    rays_per_item: int
    pixels: int
    spp: int
    triangles: int
    trace: devtrace.Trace | None = None
    traced: range = range(0)  # indices of the traced items
    work: list | None = None  # reference.trace.BounceStats of the checked paths

    @property
    def window_s(self) -> float:
        return self.ends[-1] - self.starts[0]

    def rate(self) -> float:
        """All the rays of the window over all its seconds."""
        return self.rays_per_item * len(self.ends) / self.window_s

    def latency_ms(self, q: int, untraced: bool = False) -> float:
        """The q-th percentile (1..99) of every item's latency (of every item
        outside ``traced`` with ``untraced``)."""
        lat = [(b - a) * 1e3 for i, (a, b) in enumerate(zip(self.starts, self.ends))
               if not (untraced and i in self.traced)]
        if len(lat) == 1:
            return lat[0]
        return statistics.quantiles(lat, n=100, method="inclusive")[q - 1]


class Program:
    """The cell's configuration loaded into the program: the base of the
    loops' ``Loop`` classes (``loops/``)."""

    def __init__(self, cell, seed: int, device):
        from gpupathtracer_tpu_torch.render.renderer import render_frame
        from gpupathtracer_tpu_torch.utils.config import load_scene_file

        self.render_frame = render_frame
        self.device = device
        self.traffic = cell.traffic
        scene, camera, settings = load_scene_file(cell.config_file, device=device)
        self.scene, self.camera = scene, camera
        self.settings = dataclasses.replace(settings, spp=int(self.traffic["spp"]))
        s = self.settings
        self.rays = s.width * s.height * s.spp * s.bounces
        self.triangles = int(scene.valid.sum())
        self.item_seeds = seed_stream(seed, "items")

    def describe(self, setup_s: float, starts, ends) -> Run:
        s = self.settings
        return Run(loop=self.traffic["loop"], setup_s=setup_s, starts=starts, ends=ends, rays_per_item=self.rays,
                   pixels=s.width * s.height, spp=s.spp, triangles=self.triangles)


def run_window(loop, seconds: float, trace: bool, device):
    """Items back to back until ``seconds`` have passed (the last item
    ends the window). With ``trace``, ``traced_items`` whole items after
    the first ``TRACE_START`` run under ``torch.profiler``, in memory, and
    the profile is reduced to a ``devtrace.Trace`` before the next item.
    Returns ``(starts, ends, trace, traced, host_cpu_s)``: ``traced`` the
    indices of the traced items, ``host_cpu_s`` the CPU seconds of the
    calling thread (the one that dispatches to the device) over the window."""
    from torch.profiler import ProfilerActivity, profile

    n_traced = int(loop.traffic["traced_items"]) if trace else 0
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    starts, ends, parsed, prof = [], [], None, None
    t0, c0 = time.perf_counter(), time.thread_time()
    host_cpu_s = 0.0
    i = 0
    while True:
        if n_traced and i == TRACE_START:
            prof = profile(activities=activities)
            prof.__enter__()
            tt0 = time.perf_counter()
        a = time.perf_counter()
        loop.item(i)
        b = time.perf_counter()
        starts.append(a)
        ends.append(b)
        if prof is not None and i == TRACE_START + n_traced - 1:
            # Reduce the profile and free it at once, between two items: the
            # profiler's Python events, left alive, slow the host (its
            # garbage collector walks them) for the rest of the window.
            c1 = time.thread_time()
            prof.__exit__(None, None, None)
            parsed = devtrace.parse(prof, b - tt0, n_traced)
            prof = None
            gc.collect()
            host_cpu_s -= time.thread_time() - c1
        i += 1
        if b - t0 >= seconds and (not n_traced or i >= TRACE_START + n_traced):
            break
    host_cpu_s += time.thread_time() - c0
    return starts, ends, parsed, range(TRACE_START, TRACE_START + n_traced) if parsed else range(0), host_cpu_s
