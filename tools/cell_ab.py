"""Runs benchmark cells from two checkouts on one card, in turns.

    python3 tools/cell_ab.py PARENT CHANGE OUT CELL[:TRACE] ... [--seconds S] [--seed N]

For each CELL (a workload of BENCHMARK.json; ``:1`` for a ``--trace 1``
run, default ``:0``) it runs ``h100_bench/run.py`` from PARENT, CHANGE,
CHANGE and PARENT, each pair of a side's runs on a seed of its own (the
first run of each side shares a seed with the other side's first, the
second with its second), and appends every run's two result lines (the
summary and the result) with its side, seed and exit code to OUT (a JSONL
file). Prints one line a run: the cell, side, seed, exit code and the
metrics. Checkouts come from ``tools/ab_smoke.py unpack``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ORDER = ("parent", "change", "change", "parent")
RUN_TIMEOUT_S = 600


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("out")
    p.add_argument("cells", nargs="+")
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--seed", type=int, default=2 ** 31 + 1009)
    a = p.parse_args(argv)
    roots = {"parent": os.path.abspath(a.parent), "change": os.path.abspath(a.change)}
    failed = 0
    seed = a.seed
    with open(a.out, "a") as out:
        for spec in a.cells:
            cell, _, trace = spec.partition(":")
            seeds = (seed, seed + 1)
            seed += 2
            for k, side in enumerate(ORDER):
                s = seeds[0] if k in (0, 1) else seeds[1]
                cmd = [sys.executable, "h100_bench/run.py", "--workload", cell, "--seed", str(s),
                       "--seconds", str(a.seconds), "--trace", trace or "0"]
                r = subprocess.run(cmd, cwd=roots[side], capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
                lines = r.stdout.strip().splitlines()
                row = {"cell": cell, "trace": int(trace or 0), "side": side, "seed": s, "rc": r.returncode,
                       "summary": json.loads(lines[-2]) if r.returncode == 0 else None,
                       "result": json.loads(lines[-1]) if r.returncode == 0 else None,
                       "stderr": r.stderr[-2000:] if r.returncode else ""}
                out.write(json.dumps(row) + "\n")
                out.flush()
                failed += r.returncode != 0
                metrics = {k: round(v["value"], 6) for k, v in (row["result"] or {}).get("metrics", {}).items()}
                print(f"{cell} trace={row['trace']} {side} seed={s} rc={r.returncode} {json.dumps(metrics)}",
                      flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
