"""Profiles one naive and one NEE frame of one or more checkouts of the
PyTorch + CUDA port on one card, in the order given, with each checkout's
own chip_smoke.profile_frame: device busy time, idle share of the profiled
wall time, and device time per kernel.

    python3 tools/frame_profile.py CHECKOUT [CHECKOUT ...]

Each checkout runs in a process of its own (its package and kernels, built
there), so a parent and a change can be compared in one call, in the order
parent, change, change, parent. The naive frame is chip_smoke.py's phase 5
(scenes/config3_icosphere.toml, 800x800, spp 4, 4 bounces) and the NEE
frame its phase 8 (scenes/config8_icosphere.toml, 512x512, spp 4, 3
bounces), each after one warm-up frame. Prints the card's name and power
limit first, then one JSON line per checkout and frame.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import dataclasses, json, sys, torch
import chip_smoke as cs
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils.config import load_scene_file
torch.backends.cuda.matmul.allow_tf32 = False
for cell, path in (("naive", cs.SCENE), ("nee", cs.NEE_SCENE)):
    scene, camera, settings = load_scene_file(path, device="cuda")
    settings = dataclasses.replace(settings, spp=4)
    float(render_frame(scene, camera, settings).sum())  # builds the kernels, warms up
    print(json.dumps({"checkout": sys.argv[1], "cell": cell, **cs.profile_frame(scene, camera, settings)}), flush=True)
"""


def main() -> None:
    checkouts = sys.argv[1:]
    if not checkouts:
        raise SystemExit(f"usage: {sys.argv[0]} CHECKOUT [CHECKOUT ...]")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(out.stdout.strip().splitlines()[0], flush=True)
    for checkout in checkouts:
        subprocess.run([sys.executable, "-c", CHILD, checkout], cwd=os.path.abspath(checkout), check=True,
                       timeout=900)


if __name__ == "__main__":
    main()
