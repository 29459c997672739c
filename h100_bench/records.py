"""What the program records about its own frames, for the per-layer readers.

- Spans: the device time of the work launched inside the program's
  ``render.*`` spans (``devtrace.Trace.span_device_s``; a span's time
  includes that of the spans nested inside it).
- Frame records: ``render_frame``'s host entry and return on
  ``time.perf_counter``, the clock of the window's items, and for a frame
  rendered under the profiler the (live lane, triangle column) tests its
  closest-hit searches computed
  (``gpupathtracer_tpu_torch.utils.profiling.frame_records``, the newest
  ``FRAME_RING`` untraced and traced frames), matched to the window's items
  by their start.

A program that records neither (one older than these records) gives None,
never an error.
"""

from __future__ import annotations


def span_device_ms(run, name: str) -> float | None:
    """Device ms an item of the work launched inside the spans ``name``;
    None without a trace, a device operation or such a span."""
    t = run.trace
    if t is None or t.device_ops == 0 or name not in t.span_device_s:
        return None
    return 1e3 * t.span_device_s[name] / t.items


def frames(run, traced: bool) -> list:
    """The program's records of the frames that start inside the window's
    traced items (``traced``) or inside its untraced ones; [] from a program
    that keeps no records."""
    try:
        from gpupathtracer_tpu_torch.utils.profiling import frame_records
    except ImportError:
        return []
    items = [(a, b) for i, (a, b) in enumerate(zip(run.starts, run.ends)) if (i in run.traced) == traced]
    return [r for r in frame_records() if any(a <= r["start_s"] <= b for a, b in items)]
