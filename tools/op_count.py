"""Counts the ATen operator calls of one small CPU frame of the naive and NEE
paths, for one or more checkouts of the PyTorch + CUDA port: a measure of
the host's dispatch work per frame that needs no card (the card's frames
are host-bound, PERF.md section 5).

    python3 tools/op_count.py CHECKOUT [CHECKOUT ...]

Each checkout runs in a process of its own, with its own package. The
frames are scenes/config3_icosphere.toml (naive) and
scenes/config8_icosphere.toml (NEE) at 8x8, spp 4, after one warm-up frame,
on the CPU (where the searches run their plain versions, whose calls count
too). Prints one JSON line per checkout and path: the total count and the
count of each operator.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r"""
import dataclasses, json, sys
from torch.profiler import profile
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils.config import load_scene_file
for path, cfg in (("naive", "scenes/config3_icosphere.toml"), ("nee", "scenes/config8_icosphere.toml")):
    scene, camera, settings = load_scene_file(cfg, device="cpu")
    camera = dataclasses.replace(camera, width=8, height=8)
    settings = dataclasses.replace(settings, width=8, height=8, spp=4)
    render_frame(scene, camera, settings, device="cpu")
    with profile() as prof:
        render_frame(scene, camera, settings, seed=3, device="cpu")
    ops = {e.key: e.count for e in prof.key_averages() if e.key.startswith("aten::")}
    print(json.dumps({"checkout": sys.argv[1], "path": path, "aten_calls": sum(ops.values()), "ops": ops}), flush=True)
"""


def main() -> None:
    checkouts = sys.argv[1:]
    if not checkouts:
        raise SystemExit(f"usage: {sys.argv[0]} CHECKOUT [CHECKOUT ...]")
    for checkout in checkouts:
        root = os.path.abspath(checkout)
        subprocess.run([sys.executable, "-c", CHILD, checkout], cwd=root, check=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": root})


if __name__ == "__main__":
    main()
