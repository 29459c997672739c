"""glue_device_ms (ms, device trace): device time a frame of every
kernel, copy and fill other than the four search kernels (the sample loop,
bounces and the searches' torch-op schedule)."""


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0:
        return None
    return 1e3 * (t.device_s - t.search_s()) / t.items
