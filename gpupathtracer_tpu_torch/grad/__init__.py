"""Differentiable rendering: the interior term with detached sampling.

Counterpart of ``gpupathtracer_tpu/grad/``. ``render_frame`` is
differentiable end to end (scene build, camera rays, ``resolve_hits``,
shading, the light table and the film); the discrete events (the searches,
hit or miss, the sampling decisions) are detached, as in the JAX package.
That is exact for material and emitter parameters and first-order correct
for geometry and camera within a fixed visibility. ``inverse.py`` holds the
config 5 trainer on top of it. The boundary term (``grad/edges.py`` in the
JAX package) is not ported.
"""
