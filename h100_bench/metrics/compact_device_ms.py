"""compact_device_ms (ms, program span): device time a frame of the work
launched inside the program's render.compact spans: compaction, the coherent
sort and the inverse permutation around each search."""

from h100_bench import records


def read(run):
    return records.span_device_ms(run, "render.compact")
