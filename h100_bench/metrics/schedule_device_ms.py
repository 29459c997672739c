"""schedule_device_ms (ms, program span): device time a frame of the work
launched inside the program's render.schedule spans: ray features, tile
culling, the block or cluster schedule and the straggler regroup's schedule."""

from h100_bench import records


def read(run):
    return records.span_device_ms(run, "render.schedule")
