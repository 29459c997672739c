"""anyhit_useful_pct (%, program counter): 100 x the any-hit work a frame's
K4-answered shadow rays need over the (open lane, triangle column) tests
K4 made in a traced frame (the frame's any-hit counter, averaged over the
traced frames). The work is k4_roofline_pct's (``shadow_work``: one test
for a blocked ray, the boxes entered before the cutoff for an open one,
over the shadow rays of bounces 1 and later, scaled from the checked
paths). Loose culling, or tests past a ray's first blocker, lower it."""

from h100_bench import records
from h100_bench.metrics.k4_roofline_pct import shadow_work


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0 or run.work is None:
        return None
    tests = [r.get("anyhit_tests") for r in records.frames(run, traced=True)]
    tests = [x for x in tests if x]
    work = shadow_work(run.work, run.pixels)
    if not tests or work is None:
        return None
    need = run.spp * sum(n for _, n in work)
    return 100.0 * need * len(tests) / sum(tests)
