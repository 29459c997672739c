"""rays_per_s (rays/s, host clock): W x H x spp x bounces of every frame of
the window, over the window's seconds (NEE shadow rays not counted)."""


def read(run):
    return run.rate()
