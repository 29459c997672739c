"""The readings that the check's limits are set from, in one process.

    python3 h100_bench/calibrate.py <cell> --first-seed <n> [--seeds 12] [--seconds 2]
        [--controls default,mixed,high] [--faults NAMES] [--fault-seeds 3] [--out FILE]

Runs the cell as the benchmark does (``run.run_cell``, a short window) on
``--seeds`` seeds: the sound readings. Then the program with its searches
at each precision of ``--controls`` (``faults.precision``; the first is the
check's control) and with each fault that the cell's loop kind lists in its
``FAULTS`` (or those of ``--faults``), on ``--fault-seeds`` seeds each. Prints one JSON line per
run and, last, for each number compared: the largest sound reading (the
lower reading) and the smallest reading of each control and fault. Seeds
n, n + 7919, ... are used.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT


def main(argv=None, device=None, root=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("cell")
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", default="default,mixed,high")
    p.add_argument("--faults", default=None, help="comma-separated; default: every fault the cell can have")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    from h100_bench import faults, run, spec

    root = root or ROOT
    kind = spec.loop(root, spec.load_cell(root, a.cell))
    seeds = [a.first_seed + 7919 * i for i in range(a.seeds + a.fault_seeds)]
    lines = []

    def one(label, seed, plant=contextlib.nullcontext):
        args = run.parse_args(["--workload", a.cell, "--seed", str(seed), "--seconds", str(a.seconds), "--trace", "0"])
        t0 = time.perf_counter()
        with plant():
            code, summary, result = run.run_cell(args, device, root, t0)
        row = {"kind": label, "seed": seed, "code": code}
        if result is not None:
            row.update(correct=result["correct"], numbers={k: v["value"] for k, v in result["check"].items()},
                       setup_s=summary["setup_s"], items=summary["items"], work=summary.get("work_estimate"))
        print(json.dumps(row), flush=True)
        lines.append(row)

    for seed in seeds[:a.seeds]:
        one("sound", seed)
    for precision in filter(None, a.controls.split(",")):
        for seed in seeds[:a.fault_seeds]:
            one(f"precision:{precision}", seed, lambda: faults.precision(precision))
    for fault in kind.FAULTS if a.faults is None else filter(None, a.faults.split(",")):
        for seed in seeds[:a.fault_seeds]:
            one(f"fault:{fault}", seed, kind.FAULTS[fault])
    summary = {}
    for row in lines:
        for k, v in row.get("numbers", {}).items():
            s = summary.setdefault(k, {})
            if row["kind"] == "sound":
                s["lower"] = max(s.get("lower", 0.0), v)
            else:
                s[row["kind"]] = min(s.get(row["kind"], float("inf")), v)
    print(json.dumps({"cell": a.cell, "readings": summary}), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"runs": lines, "readings": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
