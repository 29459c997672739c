"""search_useful_pct (%, program counter): 100 x the box crossings a frame
needs over the (live lane, triangle column) tests the program's closest-hit
searches computed in a traced frame (the frame's test counter, averaged
over the traced frames). The crossings are the roofline's count
(roofline.py): per ray, the triangles whose box it enters before its
closest hit, scaled from the checked paths as closest_hit_frame_bound_s
scales them. Loose culling, more tests per needed one, lowers it."""

from h100_bench import records


def crossings(stats, pixels: int, spp: int) -> float | None:
    """The box crossings of a frame's closest-hit searches; None when a
    bounce with live rays had none counted."""
    total = 0.0
    for st in stats:
        if not st.live:
            continue
        if not st.counted:
            return None
        total += pixels * st.live / st.lanes * st.tests / st.counted
    return spp * total


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0 or run.work is None:
        return None
    tests = [r["tests"] for r in records.frames(run, traced=True) if r["tests"]]
    need = crossings(run.work, run.pixels, run.spp)
    if not tests or not need:
        return None
    return 100.0 * need * len(tests) / sum(tests)
