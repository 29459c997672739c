"""The benchmark of the PyTorch and CUDA port on one NVIDIA H100.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: sets up the
program (``gpupathtracer_tpu_torch``) as the cell's configuration and
traffic files say, warms it up, runs its closed loop for ``--seconds``,
then checks what the window produced against the plain reference
(``check.py``). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; its last key, ``check``, holds every
number compared beside its limit, which also end standard error.

It exits non-zero and prints no result when there is no card (or fewer
than the cell asks for), when the program cannot be imported, and when JAX
or the JAX package has been loaded by the time the window closes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    # Import the benchmark as a package from the checkout, and never a
    # module of its folder under a standard library's name.
    sys.path[0] = ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "gpupathtracer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of ``FORBIDDEN`` (compared whole: the port's name starts with the
    JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _device_info(device, peak: int) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def run_cell(args, device=None, root=None, t_start=None):
    """Run one cell: ``(exit code, summary, result)``; the two dicts are None
    where the code is not 0. ``device`` skips the look for a card (the CPU
    tests pass ``"cpu"``); ``root`` is the checkout holding ``BENCHMARK.json``."""
    t_start = T_START if t_start is None else t_start
    root = root or ROOT
    from h100_bench import spec

    cell = spec.load_cell(root, args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2, None, None
        device = "cuda"
    from h100_bench import check, devtrace, drive

    kind = spec.loop(root, cell)
    loop = kind.Loop(cell, args.seed, device)
    drive.sync(device)
    setup_s = time.perf_counter() - t_start
    starts, ends, trace, traced, host_cpu_s = drive.run_window(loop, args.seconds, bool(args.trace), device)
    run = loop.describe(setup_s, starts, ends)
    run.trace, run.traced = trace, traced
    peak = int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0
    record = loop.record()
    del loop
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, run.work = kind.judge(cell, record, device)
    correct, rows = check.verdict(numbers, cell.limits)
    entries = cell.per_layer if args.trace else cell.end_to_end
    metrics = spec.read_metrics(root, entries, run)
    dev = _device_info(device, peak)
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.wall_s)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may load neither JAX nor the JAX package", file=sys.stderr)
        return 3, None, None
    summary = {"cell": cell.name, "items": len(ends), "window_s": run.window_s, "setup_s": setup_s,
               "latency_ms_median": run.latency_ms(50), "latency_ms_p95": run.latency_ms(95),
               "host_cpu_share": host_cpu_s / run.window_s}
    if run.work:
        summary["work_estimate"] = {
            "paths": run.work[0].lanes, "counted_rays": [w.counted for w in run.work],
            "live_share": [w.live / w.lanes for w in run.work],
            "boxes_per_ray": [w.tests / w.counted if w.counted else None for w in run.work]}
    if trace is not None:
        summary["latency_ms_median_untraced"] = run.latency_ms(50, untraced=True) if len(ends) > len(traced) else None
        summary["traced"] = {"items": trace.items, "device_ops": trace.device_ops, "busy_s": trace.busy_s,
                             "search_s": {k: trace.kernel_s(v) for k, v in devtrace.SEARCH_KERNELS.items()}}
    result = {"correct": correct, "attempted": len(ends), "failed": 0, "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = devtrace.breakdown(trace)
    result["check"] = rows
    return 0, summary, result


def main(argv=None, device=None, root=None) -> int:
    code, summary, result = run_cell(parse_args(argv), device, root)
    if code:
        return code
    print(json.dumps(summary))
    print(json.dumps(result), flush=True)
    for k, r in result["check"].items():
        print(f"check {k} = {r['value']!r} (limit {r['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
