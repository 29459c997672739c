"""Faults planted under the timed path, to show that the check fails them,
and the check's control.

Each is a context manager that patches the program (or the optimizer) for
as long as it is open. A loop kind lists the faults its cells can have in
its ``FAULTS`` (``loops/``); these are the ones that kinds share. Used by
the CPU tests and by ``calibrate.py`` on the card; no benchmark run plants
one.

- ``half_batch``: every frame sums half of its samples and takes the mean
  over those.
- ``altered_answer``: the closest-hit search reports every 16th ray as a
  miss, where the answer is produced.
- ``unchanged_state``: the optimizer's step returns the parameters
  unchanged.
- ``stray_gradient``: the frame's values unchanged, but a gradient in
  ``v0`` where the program has none (every pixel carries ``v0``'s sum
  minus itself).
- ``precision(mode)``: the control, no fault: the configuration as the
  program loads it, with every search at ``kernel_precision`` ``mode``
  (the check's control is "default", one bfloat16 product).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, make):
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        setattr(obj, name, original)


def half_batch():
    from gpupathtracer_tpu_torch.render import renderer

    def make(original):
        def accumulate_radiance(*args, **kwargs):
            spp = args[3].spp
            half = max(1, spp // 2)
            return original(*args, **{**kwargs, "num_samples": half}) * (spp / half)
        return accumulate_radiance

    return _patched(renderer, "accumulate_radiance", make)


def altered_answer():
    from gpupathtracer_tpu_torch.ops import packed_intersect
    from gpupathtracer_tpu_torch.ops.intersect import BIG, Hit

    def make(original):
        def intersect_packed(o, d, *args, **kwargs):
            h = original(o, d, *args, **kwargs)
            lanes = h.hit.clone()
            lanes[::16] = False
            return Hit(t=h.t.masked_fill(~lanes, BIG), tri=h.tri.masked_fill(~lanes, -1), hit=lanes)
        return intersect_packed

    return _patched(packed_intersect, "intersect_packed", make)


def unchanged_state():
    import torch

    return _patched(torch.optim.Adam, "step", lambda original: (lambda self, closure=None: None))


def stray_gradient():
    from gpupathtracer_tpu_torch.render import renderer

    def make(original):
        def render_frame(scene, *args, **kwargs):
            image = original(scene, *args, **kwargs)
            if scene.v0.requires_grad:
                s = scene.v0.sum()
                image = image + (s - s.detach())
            return image
        return render_frame

    return _patched(renderer, "render_frame", make)


def precision(mode: str):
    import dataclasses

    from gpupathtracer_tpu_torch.utils import config

    def make(original):
        def load_scene_file(*args, **kwargs):
            scene, camera, settings = original(*args, **kwargs)
            return scene, camera, dataclasses.replace(settings, kernel_precision=mode)
        return load_scene_file

    return _patched(config, "load_scene_file", make)
