"""The naive estimator over diffuse and emitting triangles
(``render.estimator = "naive"``); it refuses any other material and any
texture.

Each bounce searches the closest hit of the live paths. An emitter's
radiance times the throughput is added and the path ends; a diffuse hit
scatters (``trace.py``'s rules), multiplies the throughput by the albedo
and goes on. A path that misses ends.
"""

from __future__ import annotations

import torch

from h100_bench.reference.scene import DIFFUSE, EMITTER
from h100_bench.reference.trace import (RAY_OFFSET, _dot, cosine_hemisphere, fold, hit_point_and_normal, search,
                                        to_world, uniform)


def radiance(scene, boxes, albedo, o, d, keys, bounces, count_rays, stats):
    """The radiance of one sample of every path, (N, 3) float32."""
    for kind, texture in zip(scene.material_types, scene.textures):
        if kind not in (DIFFUSE, EMITTER) or texture:
            raise ValueError(f"the naive reference has no {kind!r} material{' with a texture' if texture else ''}")
    n = o.shape[0]
    dev = o.device
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    for b in range(bounces):
        tri = search(boxes, o, d, alive, stats[b] if stats is not None else None, count_rays)
        found = alive & (tri >= 0)
        mat = scene.mat[torch.clamp(tri, min=0)]
        point, n_geo = hit_point_and_normal(o, d, scene, tri)
        emit = found & scene.is_emitter[mat]
        radiance = radiance + torch.where(emit[:, None], throughput * scene.emission[mat], 0.0)
        facing = -torch.sign(_dot(d, n_geo))[:, None]
        n_shade = n_geo * torch.where(facing == 0.0, 1.0, facing)
        u = uniform(fold(keys, b), 3)
        new_d = to_world(cosine_hemisphere(u[:, 0], u[:, 1]), n_shade)
        scatter = found & ~emit
        s = scatter[:, None]
        throughput = torch.where(s, throughput * albedo.index_select(0, mat), throughput)
        o = torch.where(s, point + RAY_OFFSET * n_shade, o)
        d = torch.where(s, new_d, d)
        alive = scatter
    return radiance
