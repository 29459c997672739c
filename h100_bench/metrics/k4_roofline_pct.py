"""k4_roofline_pct (%, device trace): the least time of the traced items'
K4 launches over their device time. K4 answers the shadow rays of every
bounce after the first (the first thresholds a closest hit, K3's), one
launch a sample and bounce.

The work is what the shadow rays need (roofline.py's any-hit count: one
test for a blocked ray, the boxes entered before the cutoff for an open
one), counted by the reference over the checked paths' shadow rays
(``shadow_live``, ``shadow_counted``, ``shadow_tests`` of each bounce's
BounceStats) and scaled to the frame as closest_hit_frame_bound_s scales
crossings. Bytes: each shadow ray read once (origin and direction 24 B,
cutoff 4 B), its flag written once (1 B), each triangle's vertices once
(36 B)."""

from h100_bench import devtrace, roofline

CUTOFF_BYTES = 4
FLAG_BYTES = 1


def shadow_work(stats, pixels: int) -> list | None:
    """``[(rays, tests)]`` of a sample's K4 launches, one for each bounce
    after the first that cast shadow rays, scaled from the counted ones to
    ``pixels`` paths; None when such a bounce had none counted, or none
    cast any."""
    out = []
    for st in stats[1:]:
        live = getattr(st, "shadow_live", 0)
        if not live:
            continue
        counted = getattr(st, "shadow_counted", 0)
        if not counted:
            return None
        rays = pixels * live / st.lanes
        out.append((rays, rays * st.shadow_tests / counted))
    return out or None


def read(run):
    if run.trace is None or run.work is None:
        return None
    kernel_s = run.trace.kernel_s(devtrace.SEARCH_KERNELS["k4"])
    work = shadow_work(run.work, run.pixels)
    if kernel_s <= 0 or work is None:
        return None
    bound = run.spp * sum(roofline.bound_s(rays, tests, run.triangles, CUTOFF_BYTES + FLAG_BYTES)
                          for rays, tests in work)
    return 100.0 * bound * run.trace.items / kernel_s
