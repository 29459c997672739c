"""Compares the port in two checkouts on one card, in the order parent,
change, change, parent (``ROUNDS`` times), and prints each number of both
sides as its range. What each run measures:

- by default, ``bench.run_benchmark(backward=True, full_suite=False)`` on
  the config 3 stand-in: the headline, its fwd+bwd and the 256-spp frame;
- with ``--kernels``, the four kernels' "highest" instantiations: the
  median of 9 launches of K1 on the config 3 stand-in's camera and
  bounce-1 rays, K2 on the config 8 stand-in's bounce-1 shadow rays, K3 on
  the config 6 stand-in's camera and bounce-1 rays and K4 on its bounce-1
  shadow rays (the inputs of chip_smoke.py's phases 3, 6, 9 and 11);
- with ``--modes`` as well, every kernel also at "high", "mixed" and
  "default" on the same inputs (phase 44's).

Unpack both checkouts with ``tools/ab_smoke.py unpack`` (where git is),
then, on the machine with the card:

    python3 tools/bench_ab.py archive/ab/parent archive/ab/change OUT [ROUNDS] [--kernels [--modes]]

Each run is a fresh process in its checkout (its kernels build in that
checkout's ``gpupathtracer_tpu_torch/build/`` on the first run) that
prints its numbers as a JSON object on its last line; its output goes to
``OUT/<i>_<side>.log`` and the comparison to ``OUT/summary.json``. Exits
non-zero if any run failed.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ORDER = ("parent", "change", "change", "parent")
RUN_TIMEOUT_S = 900
SCENE = "scenes/config3_icosphere.toml"
BENCH = f"""
import json
from gpupathtracer_tpu_torch import bench
r = bench.run_benchmark(scene_path={SCENE!r}, backward=True, full_suite=False)
print(json.dumps({{
    "headline_rays_per_s": r["value"],
    "headline_median_s": r["median_s"],
    "fwd_bwd_rays_per_s": r["fwd_bwd"]["rays_per_sec"],
    "fwd_bwd_median_s": r["fwd_bwd"]["median_s"],
    "full_spp_rays_per_s": r["full_spp"]["rays_per_sec"],
    "full_spp_s": r["full_spp"]["median_s"],
}}))
"""
KERNELS = r"""
import dataclasses, json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from gpupathtracer_tpu_torch.ops import packed_intersect as pi

cs.phase_device()
cs.phase_build()
device = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
ms = {}
MODES = ("highest",)


def time(label, fn, args, modes=("highest",)):
    for mode in modes:
        key = label if mode == "highest" else f"{label} {mode}"
        ms[key] = cs.median_ms(lambda: fn(*args, precision=mode), device, reps=9)


scene, camera, settings = cs.load_scene_file(cs.SCENE, device=device)
settings = dataclasses.replace(settings, spp=4)
p1, p2 = (pi.pack_scene(scene, tri_block=tb) for tb in (settings.tri_block, settings.tri_block_secondary))
(o, d), (o2, d2) = cs.main_path_rays(scene, camera, settings, p1)
time("K1 camera", pi.closest_hit, pi.prepare_rays(o, d, p1) + (p1.w, pi.DEFAULT_RAY_TILE), MODES)
time("K1 bounce-1", pi.closest_hit, pi.prepare_rays(o2, d2, p2) + (p2.w, pi.DEFAULT_RAY_TILE), MODES)

scene, camera, settings = cs.load_scene_file(cs.NEE_SCENE, device=device)
settings = dataclasses.replace(settings, spp=4)
p1, p2 = (pi.pack_scene(scene, tri_block=tb) for tb in (settings.tri_block, settings.tri_block_secondary))
time("K2 shadow", pi.occluded, cs.nee_shadow_inputs(scene, camera, settings, p1, p2, "occluded_reference"), MODES)

scene, camera, settings = cs.load_scene_file(cs.STREAM_SCENE, device=device)
settings = dataclasses.replace(settings, spp=2)
p1, p2 = (pi.pack_scene(scene, tri_block=tb) for tb in (settings.tri_block, settings.tri_block_secondary))
(o, d), (o2, d2) = cs.main_path_rays(scene, camera, settings, p1)
time("K3 camera", pi.closest_hit_streamed, pi.prepare_rays_streamed(o, d, p1) + (pi.STREAM_RAY_TILE,), MODES)
time("K3 bounce-1", pi.closest_hit_streamed, pi.prepare_rays_streamed(o2, d2, p2) + (pi.STREAM_RAY_TILE,), MODES)
nee = dataclasses.replace(settings, estimator="nee")
time("K4 shadow", pi.occluded_streamed,
     cs.nee_shadow_inputs(scene, camera, nee, p1, p2, "occluded_streamed_reference"), MODES)
print(json.dumps(ms), flush=True)
"""


def main(parent: str, change: str, out: str, rounds: int = 1, code: str = BENCH) -> int:
    os.makedirs(out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dirs = {"parent": parent, "change": change}
    values: dict[str, dict[str, list[float]]] = {"parent": {}, "change": {}}
    failed = []
    for i, side in enumerate(ORDER * rounds):
        proc = subprocess.run([sys.executable, "-c", code], cwd=dirs[side], capture_output=True, text=True,
                              timeout=RUN_TIMEOUT_S)
        with open(os.path.join(out, f"{i}_{side}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{i}_{side}")
            print(f"run {i} ({side}) failed: {proc.stderr[-2000:]}", flush=True)
            continue
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"run {i} ({side}): {json.dumps(row)}", flush=True)
        for k, v in row.items():
            values[side].setdefault(k, []).append(v)
    summary = {"card": card, "order": list(ORDER * rounds), "failed": failed,
               "sides": {side: {k: {"min": min(v), "median": statistics.median(v), "max": max(v), "all": v}
                                for k, v in vals.items()} for side, vals in values.items()}}
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary["sides"]), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a not in ("--kernels", "--modes")]
    if len(args) not in (3, 4):
        raise SystemExit(__doc__)
    code = BENCH
    if "--kernels" in sys.argv:
        code = KERNELS
        if "--modes" in sys.argv:
            code = code.replace('MODES = ("highest",)', 'MODES = ("highest", "high", "mixed", "default")')
    sys.exit(main(*args[:3], *(int(a) for a in args[3:]), code=code))
