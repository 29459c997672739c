"""Compares the port's bench in two checkouts on one card: runs
``bench.run_benchmark(backward=True, full_suite=False)`` on the config 3
stand-in (the headline, its fwd+bwd and the 256-spp frame) in each, in the
order parent, change, change, parent (``ROUNDS`` times), and prints each
number of both sides as its range.

Unpack both checkouts with ``tools/ab_smoke.py unpack`` (where git is),
then, on the machine with the card:

    python3 tools/bench_ab.py archive/ab/parent archive/ab/change OUT [ROUNDS]

Each run is a fresh process in its checkout (its kernels build in that
checkout's ``gpupathtracer_tpu_torch/build/`` on the first run); its
output goes to ``OUT/<i>_<side>.log`` and the comparison to
``OUT/summary.json``. Exits non-zero if any run failed.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ORDER = ("parent", "change", "change", "parent")
RUN_TIMEOUT_S = 600
SCENE = "scenes/config3_icosphere.toml"
CODE = (
    "import json; from gpupathtracer_tpu_torch import bench; "
    f"print(json.dumps(bench.run_benchmark(scene_path={SCENE!r}, backward=True, full_suite=False)))"
)


def numbers(result: dict) -> dict[str, float]:
    return {
        "headline_rays_per_s": result["value"],
        "headline_median_s": result["median_s"],
        "fwd_bwd_rays_per_s": result["fwd_bwd"]["rays_per_sec"],
        "fwd_bwd_median_s": result["fwd_bwd"]["median_s"],
        "full_spp_rays_per_s": result["full_spp"]["rays_per_sec"],
        "full_spp_s": result["full_spp"]["median_s"],
    }


def main(parent: str, change: str, out: str, rounds: int = 1) -> int:
    os.makedirs(out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dirs = {"parent": parent, "change": change}
    values: dict[str, dict[str, list[float]]] = {"parent": {}, "change": {}}
    failed = []
    for i, side in enumerate(ORDER * rounds):
        proc = subprocess.run([sys.executable, "-c", CODE], cwd=dirs[side], capture_output=True, text=True,
                              timeout=RUN_TIMEOUT_S)
        with open(os.path.join(out, f"{i}_{side}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{i}_{side}")
            print(f"run {i} ({side}) failed: {proc.stderr[-2000:]}", flush=True)
            continue
        row = numbers(json.loads(proc.stdout.strip().splitlines()[-1]))
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
    if len(sys.argv) not in (4, 5):
        raise SystemExit(__doc__)
    sys.exit(main(*sys.argv[1:4], *(int(a) for a in sys.argv[4:])))
