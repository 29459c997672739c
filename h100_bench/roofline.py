"""Roofline arithmetic of the search kernels, counted from the inputs.

The work is what the rays and the triangles need, whatever searches them,
so a better culling or traversal raises the share and never shrinks its own
yardstick:

- Closest hit: for each ray, every scene triangle whose axis-aligned box
  the ray enters before its closest hit (before it leaves the scene's box
  on a miss). An exact search that culls by those boxes tests at least
  these (``reference.trace.boxes_entered`` counts them).
- Any hit: one test for an occluded ray; for an open one, the boxes entered
  before its ``max_t``.
- Each test costs ``FLOP_PER_TEST`` float32 operations, Moller-Trumbore
  with the edges given: p = d x e2 (6 multiplies, 3 subtractions: 9),
  det = e1 . p (5), 1 / det (1), s = o - v0 (3), u = (s . p) / det (6),
  q = s x e1 (9), v = (d . q) / det (6), t = (e2 . q) / det (6), u + v (1):
  46. The comparisons are not counted.
- Bytes: each ray read once (origin and direction, 24 B), each triangle's
  vertices once (36 B), each hit record written once (distance and row,
  8 B).
- The least time is max(FLOP / ``F32_FLOP_S``, bytes / ``HBM_BYTES_S``);
  the share is that bound over the kernel's device time. It cannot pass
  100% unless the count is wrong.
"""

from __future__ import annotations

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3 bandwidth.
F32_FLOP_S = 67e12
HBM_BYTES_S = 3.35e12

FLOP_PER_TEST = 46
RAY_BYTES = 24
TRIANGLE_BYTES = 36
HIT_BYTES = 8


def bound_s(rays: float, tests: float, triangles: int, out_bytes: int = HIT_BYTES) -> float:
    """The least time of one search launch over ``rays`` rays."""
    return max(FLOP_PER_TEST * tests / F32_FLOP_S,
               (rays * (RAY_BYTES + out_bytes) + triangles * TRIANGLE_BYTES) / HBM_BYTES_S)


def anyhit_tests(occluded, boxes_before_max_t) -> int:
    """Any-hit work of a batch of shadow rays (boolean and count tensors)."""
    return int(occluded.sum()) + int(boxes_before_max_t[~occluded].sum())


def closest_hit_frame_bound_s(stats, pixels: int, spp: int, triangles: int) -> float | None:
    """The least time of a frame's closest-hit launches: one launch per
    sample and bounce, over that bounce's live rays, their number and their
    box crossings scaled from the traced paths (``BounceStats``). None when
    no ray was counted."""
    total = 0.0
    for st in stats:
        if not st.live:
            continue
        if not st.counted:
            return None
        rays = pixels * st.live / st.lanes
        total += bound_s(rays, rays * st.tests / st.counted, triangles)
    return spp * total if total else None


def kernel_share_pct(run, kernel: str) -> float | None:
    """100 x the closest-hit bound of the traced items over the device time
    of ``kernel``'s launches in them; None without a trace, the kernel or
    counted work."""
    if run.trace is None or run.work is None:
        return None
    kernel_s = run.trace.kernel_s(kernel)
    if kernel_s <= 0:
        return None
    b = closest_hit_frame_bound_s(run.work, run.pixels, run.spp, run.triangles)
    return None if b is None else 100.0 * b * run.trace.items / kernel_s
