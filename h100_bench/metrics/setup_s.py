"""setup_s (s, host clock): process start to the window's start: imports,
the kernels built or loaded, the scene, the packs, the warm-up (and a step
loop's target and checked steps)."""


def read(run):
    return run.setup_s
