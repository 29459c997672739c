"""host_dispatch_ms (ms, program span): the median host time from
render_frame's entry to its return, over the program's records of the frames
that start inside the window's untraced items (in a step, its forward
frame): what the host takes to dispatch a frame, against the item's
latency. Read in traced runs, beside the device trace."""

import statistics

from h100_bench import records


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0:
        return None
    frames = records.frames(run, traced=False)
    if not frames:
        return None
    return statistics.median(1e3 * (r["end_s"] - r["start_s"]) for r in frames)
