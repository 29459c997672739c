"""kernels_per_frame (kernels, device trace): device kernels, copies
and fills a frame."""


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0:
        return None
    return t.device_ops / t.items
