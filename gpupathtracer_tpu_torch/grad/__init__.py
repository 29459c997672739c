"""Differentiable rendering: the interior term with detached sampling and
the edge-sampled boundary term.

Counterpart of ``gpupathtracer_tpu/grad/``. ``render_frame`` is
differentiable end to end (scene build, camera rays, ``resolve_hits``,
shading, the light table and the film); the discrete events (the searches,
hit or miss, the sampling decisions) are detached, as in the JAX package.
That is exact for material and emitter parameters and first-order correct
for geometry and camera within a fixed visibility. ``edges.py`` adds the
boundary term, the motion of primary and shadow silhouettes, by edge
sampling; ``edges.value_and_grad_with_edges`` sums both. ``inverse.py``
holds the config 5 trainer and the silhouette and camera demos.
"""
