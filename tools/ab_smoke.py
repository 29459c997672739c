"""Compares two checkouts of the repo on one card: runs their chip_smoke.py
in the order parent, change, change, parent and prints every timed
quantity of both sides as its range over their two runs.

The machine with the card needs no git: unpack both checkouts first, where
the repository is, into a directory that .gitignore lists, then run:

    python3 tools/ab_smoke.py unpack archive/ab/parent HEAD
    git add -A && python3 tools/ab_smoke.py unpack archive/ab/change "$(git write-tree)"
    python3 tools/ab_smoke.py run archive/ab/parent archive/ab/change OUT

``unpack DIR REV`` writes ``git archive REV`` into DIR, which must not
exist yet. ``run PARENT CHANGE OUT`` runs ``python3 chip_smoke.py`` from
each directory in turn, keeps each run's output in ``OUT/<i>_<side>.log``
and the comparison in ``OUT/summary.txt``, prints the comparison, and
exits non-zero if any run failed. A timed quantity is a
number named ``ms``, ``*_ms``, ``*_s``, ``rays_per_s`` or ``idle_share*`` in
a labelled JSON line of chip_smoke.py's output ("<label>: {...}").
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("parent", "change", "change", "parent")
RUN_TIMEOUT_S = 1200


def unpack(directory: str, rev: str) -> None:
    if os.path.exists(directory):
        raise SystemExit(f"{directory} exists: unpack into a new directory")
    os.makedirs(directory)
    archive = subprocess.Popen(["git", "archive", "--format=tar", rev], cwd=ROOT, stdout=subprocess.PIPE)
    subprocess.run(["tar", "-x", "-C", directory], stdin=archive.stdout, check=True)
    archive.stdout.close()
    if archive.wait() != 0:
        raise SystemExit(f"git archive {rev} failed")


def labelled_rows(text: str) -> dict[str, dict]:
    """``{label: JSON object}`` of each line "<label>: {...}", the label
    without its "(bar: ...)" note."""
    rows = {}
    for line in text.splitlines():
        for m in re.finditer(r": \{", line):
            try:
                row = json.loads(line[m.start() + 2 :])
            except json.JSONDecodeError:
                continue
            rows[re.sub(r"\s*\(bar:.*\)$", "", line[: m.start()])] = row
            break
    return rows


def timed(row: dict, prefix: str = "") -> dict[str, float]:
    """The timed quantities of a row, nested objects flattened with dots."""
    out = {}
    for key, value in row.items():
        name = prefix + key
        if isinstance(value, dict):
            out.update(timed(value, name + "."))
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            if key == "ms" or key.endswith(("_ms", "_s")) or key == "rays_per_s" or key.startswith("idle_share"):
                out[name] = value
    return out


def run(parent: str, change: str, out: str) -> int:
    os.makedirs(out, exist_ok=True)
    dirs = {"parent": parent, "change": change}
    values: dict[tuple[str, str], dict[str, list[float]]] = {}
    cards, failed = [], []
    for i, side in enumerate(ORDER):
        try:
            proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=dirs[side], capture_output=True,
                                  text=True, timeout=RUN_TIMEOUT_S)
            stdout, stderr, rc = proc.stdout, proc.stderr, proc.returncode
        except subprocess.TimeoutExpired as e:
            stdout, stderr, rc = e.stdout or "", e.stderr or "", "timeout"
            stdout = stdout.decode() if isinstance(stdout, bytes) else stdout
            stderr = stderr.decode() if isinstance(stderr, bytes) else stderr
        with open(os.path.join(out, f"{i}_{side}.log"), "w") as f:
            f.write(stdout + stderr)
        print(f"run {i} {side} ({dirs[side]}): rc={rc}", flush=True)
        if rc != 0:
            failed.append(f"{i}_{side}")
        cards.append(f"{i} {side}: {stdout.splitlines()[0] if stdout else '(no output)'}")
        for label, row in labelled_rows(stdout).items():
            for name, v in timed(row).items():
                values.setdefault((label, name), {"parent": [], "change": []})[side].append(v)

    lines = ["card and power limit per run: " + "; ".join(cards),
             "quantity | parent (min-max) | change (min-max) | change / parent (mean over runs)"]
    for (label, name), by_side in values.items():
        p, c = by_side["parent"], by_side["change"]
        span = lambda xs: f"{min(xs)!r}-{max(xs)!r}" if xs else "none"
        ratio = f"{(sum(c) / len(c)) / (sum(p) / len(p)):.4f}" if p and c and sum(p) else "none"
        lines.append(f"{label} . {name} | {span(p)} | {span(c)} | {ratio}")
    if failed:
        lines.append("failed runs: " + ", ".join(failed))
    text = "\n".join(lines)
    with open(os.path.join(out, "summary.txt"), "w") as f:
        f.write(text + "\n")
    print(text, flush=True)
    return 1 if failed else 0


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "unpack":
        unpack(argv[1], argv[2])
        return 0
    if len(argv) == 4 and argv[0] == "run":
        return run(argv[1], argv[2], argv[3])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
