"""Interleaved frame timing of two checkouts of the PyTorch + CUDA port on
one card: a finer A/B than tools/ab_smoke.py for frames that the host
bounds, whose wall time follows whatever else the host runs.

    python3 tools/frame_interleave.py PARENT CHANGE [ROUNDS]

Each checkout gets one process of its own (its package, its kernels built
there) that loads the naive path (scenes/config3_icosphere.toml, 800x800,
spp 4, 4 bounces) and the NEE path (scenes/config8_icosphere.toml, 512x512,
spp 4, 3 bounces) and renders one warm-up frame of each. Then, for ROUNDS
rounds (default 10), each path renders one frame in each process in the
order parent, change, change, parent (then the next round), with a varied
seed, each timed from the call to a synchronised scalar of the image: the
wall time, and the CPU time of the rendering process over that frame (the
host work it issued, less sensitive to other load on the host). Prints the
card's name and power limit, then one JSON line per path with each side's
median and quartiles of both times and the share of rounds the change won
on each.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import dataclasses, json, sys, time, torch
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils.config import load_scene_file
torch.backends.cuda.matmul.allow_tf32 = False
paths = {}
for name, cfg in (("naive", "scenes/config3_icosphere.toml"), ("nee", "scenes/config8_icosphere.toml")):
    scene, camera, settings = load_scene_file(cfg, device="cuda")
    settings = dataclasses.replace(settings, spp=4)
    float(render_frame(scene, camera, settings).sum())  # builds the kernels, packs, warms up
    paths[name] = (scene, camera, settings)
print("ready", flush=True)
for line in sys.stdin:
    name, seed = line.split()
    scene, camera, settings = paths[name]
    torch.cuda.synchronize()
    w0, c0 = time.perf_counter(), time.process_time()
    float(render_frame(scene, camera, settings, seed=int(seed)).sum())
    w1, c1 = time.perf_counter(), time.process_time()
    print(json.dumps({"wall_s": w1 - w0, "cpu_s": c1 - c0}), flush=True)
"""


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}


def main() -> None:
    if len(sys.argv) not in (3, 4):
        raise SystemExit(f"usage: {sys.argv[0]} PARENT CHANGE [ROUNDS]")
    rounds = int(sys.argv[3]) if len(sys.argv) == 4 else 10
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(out.stdout.strip().splitlines()[0], flush=True)
    procs = {}
    for side, checkout in (("parent", sys.argv[1]), ("change", sys.argv[2])):
        root = os.path.abspath(checkout)
        procs[side] = subprocess.Popen([sys.executable, "-c", CHILD], cwd=root, stdin=subprocess.PIPE,
                                       stdout=subprocess.PIPE, text=True, env={**os.environ, "PYTHONPATH": root})
    try:
        for side, proc in procs.items():
            if proc.stdout.readline().strip() != "ready":
                raise SystemExit(f"the {side} process did not start")
        for name in ("naive", "nee"):
            times = {"parent": [], "change": []}
            for r in range(rounds):
                for i, side in enumerate(("parent", "change", "change", "parent")):
                    proc = procs[side]
                    proc.stdin.write(f"{name} {1000 + 4 * r + i}\n")
                    proc.stdin.flush()
                    times[side].append(json.loads(proc.stdout.readline()))
            row = {"path": name, "rounds": rounds}
            for key in ("wall_s", "cpu_s"):
                p = [t[key] for t in times["parent"]]
                c = [t[key] for t in times["change"]]
                # a round's pair: the mean of each side's two frames in it
                pairs = [((p[2 * r] + p[2 * r + 1]) / 2, (c[2 * r] + c[2 * r + 1]) / 2) for r in range(rounds)]
                row[key] = {"parent": _quartiles(p), "change": _quartiles(c),
                            "change_won_share": sum(cc < pp for pp, cc in pairs) / rounds}
            print(json.dumps(row), flush=True)
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait(timeout=60)


if __name__ == "__main__":
    main()
