"""What the render path's spans cost with no profiler running, on this host.

    python3 tools/span_overhead.py [SCENE] [SPP]

Times a guarded ``profiling.scope`` with no profiler (and a sampler
method's span wrapper), counts the spans a frame of SCENE (default the
config 3 stand-in at spp 4, the benchmark's c3-render frame) opens under
the profiler, times untraced frames, and prints one JSON line: the cost a
span, the spans a frame, their cost as a share of the frame's median
time, and the device the frames ran on.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from gpupathtracer_tpu_torch.ops import sampling  # noqa: E402
from gpupathtracer_tpu_torch.render.renderer import render_frame  # noqa: E402
from gpupathtracer_tpu_torch.utils import profiling  # noqa: E402
from gpupathtracer_tpu_torch.utils.config import load_scene_file  # noqa: E402


def per_call_us(fn, n: int = 200_000) -> float:
    return min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e6


def main(argv) -> None:
    scene_path = argv[0] if argv else os.path.join(ROOT, "scenes", "config3_icosphere.toml")
    spp = int(argv[1]) if len(argv) > 1 else 4
    device = "cuda" if torch.cuda.is_available() else "cpu"

    def guarded():
        with profiling.scope("render.x"):
            pass

    wrapped = sampling._rng_span(lambda: None).__func__
    scope_us = per_call_us(guarded)
    wrapper_us = per_call_us(wrapped) - per_call_us(lambda: None)

    scene, camera, settings = load_scene_file(scene_path, device=device)
    settings = dataclasses.replace(settings, spp=spp)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    for s in range(3):
        render_frame(scene, camera, settings, seed=s, device=device)
    sync()
    frame_ms = []
    for s in range(10):
        t0 = time.perf_counter()
        render_frame(scene, camera, settings, seed=100 + s, device=device)
        sync()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_frame(scene, camera, settings, seed=7, device=device)
        sync()
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("render."):
            spans[e.name()] = spans.get(e.name(), 0) + 1
    n = sum(spans.values())
    rng = spans.get("render.rng", 0)  # the wrapper's time includes its scope's
    cost_ms = ((n - rng) * scope_us + rng * wrapper_us) / 1e3
    median = statistics.median(frame_ms)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "guarded_scope_us": scope_us, "rng_wrapper_us": wrapper_us, "spans_per_frame": n, "spans": spans,
        "spans_cost_ms": cost_ms, "frame_ms_median": median, "frame_ms": frame_ms,
        "spans_cost_share_pct": 100.0 * cost_ms / median,
    }))


if __name__ == "__main__":
    main(sys.argv[1:])
