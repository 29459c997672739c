"""Counts the host's dispatcher ops of one traced frame by the program's
``render.*`` span they run in, and the device work launched from each.

    python3 tools/ops_by_span.py [--device cuda|cpu] [--size N]

Renders the config 3 stand-in at spp 4 and the config 6 stand-in at spp 2
(scenes/config3_icosphere.toml, scenes/config6_icosphere.toml) at N x N
(default 800), once to warm up and once under torch.profiler, and prints a
JSON line a frame: for each span name, its calls, the top-level ATen ops
run in it (an op nested in another op is not counted; an op counts in the
innermost span around it, so a span's count leaves out its nested spans'),
the ops that reached the dispatcher through the port's own kernels
(``firefly_*``), and the device kernels, copies and fills those ops
launched. The op counts of a span do not depend on N.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpupathtracer_tpu_torch.render.renderer import render_frame  # noqa: E402
from gpupathtracer_tpu_torch.utils.config import load_scene_file  # noqa: E402

FRAMES = (("config3", "config3_icosphere.toml", 4), ("config6", "config6_icosphere.toml", 2))


def _span(e):
    """The innermost render.* span around event ``e`` (None outside any)."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("render."):
        p = p.cpu_parent
    return None if p is None else p.name


def _top_level(e) -> bool:
    p = e.cpu_parent
    while p is not None and not p.name.startswith("render."):
        if p.name.startswith(("aten::", "firefly_")):
            return False
        p = p.cpu_parent
    return True


def count(path: str, spp: int, size: int, device: torch.device) -> dict:
    scene, camera, settings = load_scene_file(os.path.join(ROOT, "scenes", path), device=device)
    camera = dataclasses.replace(camera, width=size, height=size)
    settings = dataclasses.replace(settings, width=size, height=size, spp=spp)
    render_frame(scene, camera, settings, device=device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        render_frame(scene, camera, settings, seed=5, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
    out = collections.defaultdict(lambda: collections.Counter())
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith("render."):
            out[e.name]["calls"] += 1
            continue
        if not e.name.startswith(("aten::", "firefly_")) or not _top_level(e):
            continue
        span = _span(e) or "outside"
        out[span]["aten_ops" if e.name.startswith("aten::") else "port_kernel_ops"] += 1
        out[span]["device_ops"] += len(e.kernels)
    return {k: dict(v) for k, v in sorted(out.items())}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, default=800)
    a = p.parse_args()
    device = torch.device(a.device)
    for label, path, spp in FRAMES:
        print(json.dumps({"frame": label, "spp": spp, "size": a.size, "device": str(device),
                          "spans": count(path, spp, a.size, device)}), flush=True)


if __name__ == "__main__":
    main()
