"""Device time of each search launch of a streamed NEE frame, in launch order.

    python3 tools/nee_frame_split.py [--config h100_bench/configs/config6_nee.json] [--spp 1] [--frames 3]

Loads the configuration as the benchmark does (``load_scene_file``, spp
from ``--spp``), renders two warm-up frames, counting the search launches
of the second (``_build.launch_counts``), then renders ``--frames``
frames, each under its own ``torch.profiler`` session. For each frame it
prints the K3 and K4 launches in order with their device ms, the device's
busy time (the union of every kernel, copy and fill), and two shares of it:
K3 and K4 together, and the shadow searches (bounce 0's thresholded K3,
the second K3 launch of each sample, and every K4). Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K3, K4 = "closest_hit_streamed_kernel", "occlusion_streamed_kernel"


def union_ms(intervals) -> float:
    total, end = 0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total * 1e-6


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gpupathtracer_tpu_torch.ops import _build
    from gpupathtracer_tpu_torch.render.renderer import render_frame
    from gpupathtracer_tpu_torch.utils.config import load_scene_file

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=os.path.join(ROOT, "h100_bench", "configs", "config6_nee.json"))
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--frames", type=int, default=3)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    scene, camera, settings = load_scene_file(a.config, device="cuda")
    settings = dataclasses.replace(settings, spp=a.spp)
    frame = lambda seed: render_frame(scene, camera, settings, seed=seed, device="cuda")
    frame(1)
    torch.cuda.synchronize()
    before = _build.launch_counts["closest_hit_streamed"], _build.launch_counts["occlusion_streamed"]
    frame(2)
    torch.cuda.synchronize()
    launches = {"k3": _build.launch_counts["closest_hit_streamed"] - before[0],
                "k4": _build.launch_counts["occlusion_streamed"] - before[1]}
    print(json.dumps({"card": card, "config": os.path.relpath(a.config, ROOT), "spp": settings.spp,
                      "bounces": settings.bounces, "estimator": settings.estimator,
                      "launches_per_frame": launches}), flush=True)
    per_sample = settings.bounces + 1  # the path searches and bounce 0's shadow search
    for f in range(a.frames):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            frame(100 + f)
            torch.cuda.synchronize()
        dev = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
        k3 = [(b - s) * 1e-6 for s, b, n in dev if K3 in n]
        k4 = [(b - s) * 1e-6 for s, b, n in dev if K4 in n]
        busy = union_ms([(s, b) for s, b, _ in dev])
        shadow = sum(k4) + sum(t for i, t in enumerate(k3) if i % per_sample == 1)
        print(json.dumps({"frame": f, "k3_ms": k3, "k4_ms": k4, "busy_ms": busy, "device_ops": len(dev),
                          "k3_k4_share": (sum(k3) + sum(k4)) / busy, "shadow_share": shadow / busy}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
