"""rng_device_ms (ms, program span): device time a frame of the work launched
inside the program's render.rng spans: the path samplers' key, fold and
uniform draws."""

from h100_bench import records


def read(run):
    return records.span_device_ms(run, "render.rng")
