"""Profiles one forward+backward frame of each of chip_smoke.py's full-size
paths on one card: the bench's loss, mean(image), differentiated in v0 and
the material albedo (gpupathtracer_tpu_torch.bench.bench_loss_grads), after
one warm-up frame.

    python3 tools/grad_profile.py [OUT_DIR]

Paths: config 3 naive (scenes/config3_icosphere.toml, 800x800, spp 4,
4 bounces), config 8 NEE (scenes/config8_icosphere.toml, 512x512, spp 4,
3 bounces) and config 6 streamed naive (scenes/config6_icosphere.toml,
800x800, spp 2, 4 bounces). For each: the wall time of the forward (to a
synchronised loss) and of the backward (to synchronised gradients), and
under torch.profiler (chip_smoke.profile_frame) the wall time, the device
busy time, the device's idle share of that wall time, the device launches
and the device time of each kernel of the port and of the 12 costliest
kernel names. Prints the card's name and power limit first, then
one JSON line per path; with OUT_DIR, also writes each path's Chrome trace
there.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from gpupathtracer_tpu_torch.utils.config import load_scene_file  # noqa: E402

PATHS = (("config3 naive", cs.SCENE, 4), ("config8 nee", cs.NEE_SCENE, 4), ("config6 streamed naive", cs.STREAM_SCENE, 2))


def fwd_bwd(scene, leaves, camera, settings, seed):
    """Wall ms of the forward to a synchronised loss and of the backward to
    synchronised gradients."""
    device = scene.v0.device
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    loss = cs.render_frame(scene, camera, settings, seed=seed).mean()
    float(loss.detach())
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    del grads
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def profile_path(label, path, spp, out_dir):
    device = torch.device("cuda")
    scene, camera, settings = load_scene_file(path, device=device)
    settings = dataclasses.replace(settings, spp=spp)
    leaf, leaves = cs.bench_leaves(scene)
    fwd_bwd(leaf, leaves, camera, settings, seed=1)  # builds the kernels, packs, warms up
    fwd_ms, bwd_ms = fwd_bwd(leaf, leaves, camera, settings, seed=2)
    trace = os.path.join(out_dir, f"fwd_bwd_{label.replace(' ', '_')}.json") if out_dir else None
    profiled = cs.profile_frame(lambda: fwd_bwd(leaf, leaves, camera, settings, seed=3), trace, top=12)
    row = {"path": label, "size": [settings.width, settings.height], "spp": settings.spp,
           "bounces": settings.bounces, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, **profiled}
    print(json.dumps(row), flush=True)


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(out.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, path, spp in PATHS:
        profile_path(label, path, spp, out_dir)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
