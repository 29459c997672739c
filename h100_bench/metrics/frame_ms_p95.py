"""frame_ms_p95 (ms, host clock): the 95th percentile of every frame of the
window, each from its start to its image synchronised on the device."""


def read(run):
    return run.latency_ms(95)
