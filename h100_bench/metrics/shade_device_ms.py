"""shade_device_ms (ms, program span): device time a frame of the work launched
inside the program's render.shade spans: hit attributes, materials,
emission, light samples, scatter and roulette, render.rng's draws inside it
included."""

from h100_bench import records


def read(run):
    return records.span_device_ms(run, "render.shade")
