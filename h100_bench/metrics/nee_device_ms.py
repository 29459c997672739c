"""nee_device_ms (ms, program span): device time a frame of the work
launched inside the program's render.nee spans: the light pick, the shadow
rays' geometry, compaction and schedule, and bounce 0's thresholded closest
hit's torch ops. K3's and K4's own launches are bare ctypes calls, linked to
no span: k4_roofline_pct reads K4 by name."""

from h100_bench import records


def read(run):
    return records.span_device_ms(run, "render.nee")
