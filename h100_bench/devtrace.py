"""The rules that the per-layer readers share for a ``torch.profiler`` trace.

The profile is read in memory (no Chrome trace is written). A device
operation is every kernel, copy and fill the card ran; the device's busy
time is the union of their intervals. The search kernels are matched by
name, as the program's CUDA sources name them.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools

# The program's four search kernels, by the name their CUDA entry carries
# (none of these names is a substring of another).
SEARCH_KERNELS = {
    "k1": "closest_hit_kernel",
    "k2": "occlusion_kernel",
    "k3": "closest_hit_streamed_kernel",
    "k4": "occlusion_streamed_kernel",
}


@dataclasses.dataclass
class Trace:
    wall_s: float  # host clock over the traced items
    items: int  # frames or steps traced
    busy_s: float  # union of the device intervals
    device_ops: int  # kernels, copies and fills
    device_s: float  # sum of their durations
    by_name: dict  # device seconds by operation name
    span_device_s: dict  # span name: device seconds of the work launched inside it
    idle_by_host: list  # [[what the host was doing, idle seconds], ...]

    def kernel_s(self, kernel: str) -> float:
        return sum(v for k, v in self.by_name.items() if kernel in k)

    def search_s(self) -> float:
        return sum(self.kernel_s(k) for k in SEARCH_KERNELS.values())


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(intervals, start: float, stop: float):
    """The uncovered ``(start, end)`` pieces of [start, stop]."""
    out, end = [], start
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, stop)))
        end = max(end, b)
        if end >= stop:
            break
    if end < stop:
        out.append((end, stop))
    return [(a, b) for a, b in out if b > a]


def innermost_at(points, ops):
    """For each time in ``points`` (sorted), the name of the shortest op
    ``(start, end, name)`` that covers it, or None."""
    ops = sorted(ops)
    heap, i, out = [], 0, []
    for p in points:
        while i < len(ops) and ops[i][0] <= p:
            a, b, name = ops[i]
            heapq.heappush(heap, (b - a, b, name))
            i += 1
        # Points only grow, so an op that has ended stays ended: drop it once
        # it is the shortest; the shortest left has not ended.
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def _events(prof):
    return prof.profiler.kineto_results.events()


def parse(prof, wall_s: float, items: int) -> Trace:
    """The trace of ``items`` frames or steps profiled by ``prof``."""
    from torch.autograd import DeviceType

    dev, cpu, launch_ns, spans = [], [], {}, {}
    for e in _events(prof):
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            dev.append((start, start + dur, e.name(), e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            if e.correlation_id():
                launch_ns[e.correlation_id()] = start
            if e.is_user_annotation():  # a record_function span
                spans.setdefault(e.name(), []).append((start, start + dur))
            cpu.append((start, start + dur, e.name()))
    by_name = {}
    for a, b, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    # Device work by the time of its launch, for the spans' sums.
    launched = sorted((launch_ns[c], b - a) for a, b, _, c in dev if c in launch_ns)
    at = [t for t, _ in launched]
    total = [0, *itertools.accumulate(d for _, d in launched)]
    span_s = {name: sum(total[bisect.bisect_right(at, hi)] - total[bisect.bisect_left(at, lo)] for lo, hi in ivs) * 1e-9
              for name, ivs in spans.items()}
    intervals = [(a, b) for a, b, _, _ in dev]
    idle = []
    if cpu and dev:
        lo = min(a for a, _, _ in cpu)
        hi = max(b for _, b, _ in cpu)
        holes = gaps(intervals, lo, hi)
        labels = innermost_at([(a + b) / 2 for a, b in holes], cpu) if holes else []
        agg = {}
        for (a, b), name in zip(holes, labels):
            key = name or "host outside any traced op"
            n, s = agg.get(key, (0, 0.0))
            agg[key] = (n + 1, s + (b - a) * 1e-9)
        idle = [[f"{k[:100]} ({n} gaps)", s] for k, (n, s) in sorted(agg.items(), key=lambda kv: -kv[1][1])]
    return Trace(
        wall_s=wall_s,
        items=items,
        busy_s=union_length(intervals) * 1e-9,
        device_ops=len(dev),
        device_s=sum(b - a for a, b, _, _ in dev) * 1e-9,
        by_name=by_name,
        span_device_s=span_s,
        idle_by_host=idle,
    )


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the idle time by what the host was doing, in seconds."""
    ops = sorted(trace.by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:120], v] for k, v in ops], "idle_gaps": trace.idle_by_host[:top]}
