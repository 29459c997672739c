"""Builds and times the PCG sampler's kernels (``csrc/pcg.cu``) on the card.

    python3 tools/pcg_kernels.py [--frames N]

Prints the card's name and power limit, builds the PCG library alone (its
nvcc seconds and ptxas's registers per kernel), then runs ``chip_smoke.py``'s
phase 46: the path-key, fold and draw kernels at a frame's 640,000 lanes,
bit-equal to the plain int64 route, with each one's device and host ms, the
bytes bound and the plain route's ms. About 20 s on an H100. With
``--frames N``, also N profiled frames each of the benchmark's config 3
(spp 4) and config 6 (spp 2) stand-ins (``chip_smoke.profile_frame``): the
sampler's launches a frame and its kernels' device ms a frame beside the
frame's wall, busy and device launches, after one frame of each checked to
the bit against the same frame with the sampler's plain int64 route patched
in (about a minute more).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gpupathtracer_tpu_torch.ops import _build, sampling  # noqa: E402
from gpupathtracer_tpu_torch.render.renderer import render_frame  # noqa: E402
from gpupathtracer_tpu_torch.utils.config import load_scene_file  # noqa: E402


def profile_frames(path: str, spp: int, frames: int) -> None:
    scene, camera, settings = load_scene_file(path, device="cuda")
    settings = dataclasses.replace(settings, spp=spp)
    got = render_frame(scene, camera, settings, seed=1)  # also the warm-up: packs, kernels
    kernels = {name: getattr(sampling, f"_{name}_kernel") for name in ("path_keys", "fold", "uniform")}
    try:
        for name in kernels:
            setattr(sampling, f"_{name}_kernel", getattr(sampling, f"_{name}_plain"))
        want = render_frame(scene, camera, settings, seed=1)
    finally:
        for name, fn in kernels.items():
            setattr(sampling, f"_{name}_kernel", fn)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{path}: the frame differs from the plain route's")
    print(f"frame {os.path.basename(path)} spp {spp}: bit-equal to the plain route's", flush=True)
    for i in range(frames):
        before = _build.launch_counts[_build.PCG]
        row = chip_smoke.profile_frame(lambda: float(render_frame(scene, camera, settings, seed=100 + i).sum()))
        row["pcg_launches"] = _build.launch_counts[_build.PCG] - before
        print(f"frame {os.path.basename(path)} spp {spp}: {json.dumps(row)}", flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=0)
    frames = p.parse_args().frames
    chip_smoke.phase_device()
    t0 = time.perf_counter()
    report = _build.build((_build.PCG,))[_build.PCG]
    print(f"build: {_build.source(_build.PCG)} in {time.perf_counter() - t0:.2f} s; "
          f"ptxas: {chip_smoke.ptxas_usage(report)}", flush=True)
    chip_smoke.phase_pcg(torch.device("cuda"))
    if frames:
        profile_frames(chip_smoke.SCENE, 4, frames)
        profile_frames(chip_smoke.STREAM_SCENE, 2, frames)


if __name__ == "__main__":
    main()
