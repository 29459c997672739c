"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, loop, cell or
metric is a file of its own under the benchmark's folder, found by the name
that ``BENCHMARK.json`` (or a traffic file) gives it:

- ``configs/<config>.json``: a configuration (its entry's ``file``); its
  ``render.estimator`` picks the reference's estimator,
  ``reference/<estimator>.py``;
- ``traffic/<traffic>.json``: a traffic mix, the parameters of the loop
  that its ``"loop"`` names;
- ``loops/<loop>.py``: a loop kind (``loops/__init__.py`` says what it
  exports: the program's closed loop, its judge and its faults);
- ``limits/<cell>.json``: the limit of each number that decides the cell's
  ``correct``;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` for each
  metric, end to end or per layer; a metric ``<base>.<part>`` without a file
  of its own is read by ``metrics/<base>.py``.

So a later change adds a cell, a configuration, a mix, a loop or a metric by
adding files and entries, and edits no code.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

BENCH_DIR = "h100_bench"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_file: str  # absolute path
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list  # BENCHMARK.json entries of the metrics the cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = os.path.join(root, BENCH_DIR)
    return Cell(
        name=name,
        config_file=os.path.join(root, config["file"]),
        traffic=_load_json(os.path.join(bench, "traffic", w["traffic"] + ".json")),
        chips=int(w["chips"]),
        limits=_load_json(os.path.join(bench, "limits", name + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def module(root: str, kind: str, name: str):
    """``<root>/h100_bench/<kind>/<name>.py``, loaded once under the name
    ``h100_bench.<kind>.<name>``."""
    path = os.path.join(root, BENCH_DIR, kind, name + ".py")
    if not os.path.exists(path):
        raise SystemExit(f"no {kind} named {name!r}: {os.path.relpath(path, root)} is missing")
    qual = f"{BENCH_DIR}.{kind}.{name}"
    mod = sys.modules.get(qual)
    if mod is not None and os.path.abspath(getattr(mod, "__file__", "")) == os.path.abspath(path):
        return mod
    mod_spec = importlib.util.spec_from_file_location(qual, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[qual] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def loop(root: str, cell: Cell):
    """The module of the cell's loop kind, ``loops/<traffic["loop"]>.py``."""
    return module(root, "loops", cell.traffic["loop"])


def reader(root: str, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``, or of
    ``metrics/<metric up to its last dot>.py`` where the first is missing."""
    path = os.path.join(root, BENCH_DIR, "metrics", metric + ".py")
    if not os.path.exists(path) and "." in metric:
        metric = metric.rsplit(".", 1)[0]
        path = os.path.join(root, BENCH_DIR, "metrics", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location(f"{BENCH_DIR}.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(root: str, entries: list, run) -> dict:
    """``{name: {"value", "unit"}}`` of every entry whose reader finds
    something to read in ``run``."""
    out = {}
    for m in entries:
        value = reader(root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
