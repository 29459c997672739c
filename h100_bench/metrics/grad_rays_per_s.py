"""grad_rays_per_s (rays/s, host clock): W x H x spp x bounces of every
gradient step of the window, over the window's seconds."""


def read(run):
    return run.rate()
