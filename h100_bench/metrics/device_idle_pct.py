"""device_idle_pct (%, device trace): 100 x (1 - the device's busy time an
item / the median latency of the window's untraced items). The busy time is
the union of the device's kernel, copy and fill intervals over the traced
items; the latency is taken outside them, because the profiler's own host
cost stretches a traced item several times over while the device's work
stays the same."""


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0 or len(run.ends) <= len(run.traced):
        return None
    return 100.0 * (1.0 - 1e3 * t.busy_s / t.items / run.latency_ms(50, untraced=True))
