"""Next-event estimation over diffuse and emitting triangles
(``render.estimator = "nee"``); it refuses any other material and any
texture. Multiple importance sampling would be its own estimator,
``reference/mis.py``, which the reference does not have.

Each bounce searches the closest hit of the live paths. An emitter's
radiance times the throughput is added only where the previous vertex
sampled no light (the camera samples none), and the path ends. At a diffuse
hit the vertex samples one point on an emitter and casts one shadow ray to
it, then scatters as the naive estimator does (``naive.py``, ``trace.py``'s
rules). The light sample, in float32 and in this order:

- The light table: each triangle's area, |e1 x e2| / 2 in float64, times 1
  for an emitting triangle and 0 for any other; the CDF is the float64
  prefix sum over the triangles in scene order, rounded once to float32,
  and the total is the float32 sum of the rounded areas.
- The pick: three uniforms of the key folded with the bounce, then with
  ``LIGHT_STREAM``; the triangle is the first whose CDF exceeds u0 times the
  total (clamped to the last row); the point is v0 + b1 e1 + b2 e2 with
  b1 = sqrt(u1) (1 - u2), b2 = sqrt(u1) u2.
- The geometry: wi = y - x over its length (the squared length held at
  least 1e-12), cos_x = n . wi with n the normal turned against the ray,
  cos_y = |n_light . wi| (two-sided lights), and the term
  max(cos_x, 0) cos_y / r^2 times the total area.
- Visibility: the shadow ray starts ``RAY_OFFSET`` along n from the hit
  point and is blocked by any accepted hit at t in (1e-6, cutoff), cutoff =
  r (1 - 1e-3), which keeps the sampled triangle out of its own test. The
  test is exact in float64 (``trace.closest_hit``, thresholded).
- The contribution throughput (albedo / pi) Le times the term is added
  where the ray is not blocked and the total area is above 0.

This is the published next-event estimator (Veach's thesis, section 4.3:
area sampling of the emitters with the solid-angle conversion above); the
reference departs from it nowhere.

The camera rays (``trace_pixels`` here) are the published viewer's rays
evaluated as it evaluates them, in float32 (``camera_rays``: glm's
lookAtRH, perspectiveFovRH and inverses, then ``trace.py``'s rule), where
``trace.trace_pixels`` evaluates the same rule in float64. The naive
estimator's radiance depends only on which triangles a path meets, but
the light sample's geometry term depends on where on them it lands: the
float64 rays put the hit points up to 7e-4 away from the float32 ones at
grazing angles, enough to move a pixel by more than the check's 1e-4.

For ``count_rays`` shadow rays of each bounce, spread evenly over them, it
counts the any-hit work that the roofline counts (``roofline.anyhit_tests``:
1 for a blocked ray, the boxes entered before the cutoff for an open one)
into the bounce's ``BounceStats`` as ``shadow_live`` (shadow rays cast),
``shadow_counted`` and ``shadow_tests``.
"""

from __future__ import annotations

import math

import torch

from h100_bench.reference.scene import DIFFUSE, EMITTER, RefCamera
from h100_bench.reference.trace import (JITTER_STREAM, RAY_OFFSET, _dot, _safe_normalize, boxes_entered,
                                        closest_hit, cosine_hemisphere, fold, hit_point_and_normal, path_keys, search,
                                        to_world, uniform)
from h100_bench.roofline import anyhit_tests

LIGHT_STREAM = 0x11EE
CUTOFF_SCALE = 1.0 - 1e-3


def _look_at_rh(eye, center, up):
    f = _safe_normalize(center - eye)
    s = _safe_normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    m = torch.eye(4, dtype=torch.float32, device=eye.device)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -torch.dot(s, eye), -torch.dot(u, eye), torch.dot(f, eye)
    return m


def _perspective_fov_rh(fov, width, height, near, far):
    h = torch.cos(0.5 * fov) / torch.sin(0.5 * fov)
    m = torch.zeros((4, 4), dtype=torch.float32, device=fov.device)
    m[0, 0] = h * height / width
    m[1, 1] = h
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def camera_rays(cam: RefCamera, pixels: torch.Tensor, jitter: torch.Tensor | None):
    """Origins and unit directions through the given pixels, by
    ``trace.py``'s camera rule evaluated in float32 as the published viewer
    does: the basis from yaw and pitch, glm's lookAtRH and perspectiveFovRH,
    their float32 inverses, then pixel (x, y) plus the jitter through them."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=pixels.device)
    pos, world_up, far = f32(cam.position), f32(cam.world_up), f32(cam.far)
    yaw, pitch = torch.deg2rad(f32(cam.yaw)), torch.deg2rad(f32(cam.pitch))
    front = torch.stack([torch.cos(yaw) * torch.cos(pitch), torch.sin(pitch), torch.sin(yaw) * torch.cos(pitch)])
    forward = _safe_normalize(front)
    right = _safe_normalize(torch.linalg.cross(forward, world_up))
    up = _safe_normalize(torch.linalg.cross(right, forward))
    view = _look_at_rh(pos, pos + forward, up)
    proj = _perspective_fov_rh(torch.deg2rad(f32(cam.fov_deg)), f32(float(cam.width)), f32(float(cam.height)),
                               f32(cam.near), far)
    w, h = cam.width, cam.height
    xs = (pixels % w).to(torch.float32)
    ys = torch.div(pixels, w, rounding_mode="floor").to(torch.float32)
    if jitter is not None:
        xs = xs + jitter[:, 0]
        ys = ys + jitter[:, 1]
    px = (xs / float(w)) * 2.0 - 1.0
    py = 1.0 - (ys / float(h)) * 2.0
    ones = torch.ones_like(px)
    clip = torch.stack([px, py, ones, ones], dim=-1) * far
    look = clip @ (torch.linalg.inv(view) @ torch.linalg.inv(proj)).T
    d = _safe_normalize(look[:, :3] - pos[None, :])
    return pos[None, :].expand_as(d), d


def trace_pixels(scene, boxes, cam: RefCamera, pixels: torch.Tensor, seed: int, spp: int, bounces: int,
                 count_rays: int = 0, stats: list | None = None) -> torch.Tensor:
    """``trace.trace_pixels`` of this estimator with the float32 camera
    rays (``camera_rays``): the radiance summed over samples 0 .. spp - 1
    of the given pixels, (P, 3) float32. The rays and keys are made for the
    whole frame, as a frame is rendered, and the pixels taken from them."""
    frame = torch.arange(cam.width * cam.height, device=pixels.device)
    film = torch.zeros((pixels.shape[0], 3), dtype=torch.float32, device=pixels.device)
    for s in range(spp):
        keys = path_keys(seed, frame, s)
        ju = uniform(fold(keys, JITTER_STREAM), 2) if spp > 1 else None
        o, d = camera_rays(cam, frame, ju)
        film = film + radiance(scene, boxes, scene.albedo, o[pixels], d[pixels], keys[pixels], bounces, count_rays,
                               stats)
    return film


def light_table(scene):
    """``(cdf, total)``, float32: the area-weighted CDF over every triangle
    (0 weight for one that does not emit) and the total emitting area."""
    area = 0.5 * torch.linalg.norm(torch.linalg.cross(scene.e1.double(), scene.e2.double()), dim=-1)
    weight = area * scene.is_emitter[scene.mat].to(torch.float64)
    return torch.cumsum(weight, 0).float(), weight.float().sum()


def visible(boxes, o, d, cutoff, lanes, stats, count_rays):
    """(N,) bool: True where the shadow ray of a lane in ``lanes`` has no
    accepted hit at t in (1e-6, ``cutoff``); False elsewhere."""
    idx = torch.nonzero(lanes).flatten()
    out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if idx.numel() == 0:
        return out
    _, t = closest_hit(boxes, o[idx], d[idx])
    blocked = t < cutoff[idx].double()
    out[idx] = ~blocked
    if stats is not None:
        stats.shadow_live = getattr(stats, "shadow_live", 0) + int(idx.numel())
        if count_rays:
            pick = torch.arange(0, idx.numel(), max(1, idx.numel() // count_rays), device=o.device)[:count_rays]
            k = idx[pick]
            entered = boxes_entered(boxes, o[k], d[k], cutoff[k])
            stats.shadow_counted = getattr(stats, "shadow_counted", 0) + int(k.numel())
            stats.shadow_tests = getattr(stats, "shadow_tests", 0) + anyhit_tests(blocked[pick], entered)
    return out


def radiance(scene, boxes, albedo, o, d, keys, bounces, count_rays, stats):
    """The radiance of one sample of every path, (N, 3) float32."""
    for kind, texture in zip(scene.material_types, scene.textures):
        if kind not in (DIFFUSE, EMITTER) or texture:
            raise ValueError(f"the nee reference has no {kind!r} material{' with a texture' if texture else ''}")
    n = o.shape[0]
    dev = o.device
    cdf, total = light_table(scene)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    sampled_light = torch.zeros((n,), dtype=torch.bool, device=dev)  # the camera samples no light
    for b in range(bounces):
        st = stats[b] if stats is not None else None
        tri = search(boxes, o, d, alive, st, count_rays)
        found = alive & (tri >= 0)
        mat = scene.mat[torch.clamp(tri, min=0)]
        point, n_geo = hit_point_and_normal(o, d, scene, tri)
        emit = found & scene.is_emitter[mat]
        radiance = radiance + torch.where((emit & ~sampled_light)[:, None], throughput * scene.emission[mat], 0.0)
        facing = -torch.sign(_dot(d, n_geo))[:, None]
        n_shade = n_geo * torch.where(facing == 0.0, 1.0, facing)
        kb = fold(keys, b)
        u = uniform(kb, 3)
        scatter = found & ~emit
        a = albedo.index_select(0, mat)

        # The light sample and its shadow ray.
        ul = uniform(fold(kb, LIGHT_STREAM), 3)
        pick = torch.clamp(torch.searchsorted(cdf, ul[:, 0] * total, right=True), 0, scene.num_triangles - 1)
        su = torch.sqrt(ul[:, 1])
        b1 = su * (1.0 - ul[:, 2])
        b2 = su * ul[:, 2]
        e1, e2 = scene.e1.index_select(0, pick), scene.e2.index_select(0, pick)
        y = scene.v0.index_select(0, pick) + b1[:, None] * e1 + b2[:, None] * e2
        x = torch.where(found[:, None], point, o)
        wi_raw = y - x
        dist2 = torch.clamp(_dot(wi_raw, wi_raw), min=1e-12)
        dist = torch.sqrt(dist2)
        wi = wi_raw / dist[:, None]
        cos_x = _dot(n_shade, wi)
        cos_y = torch.abs(_dot(_safe_normalize(torch.linalg.cross(e1, e2)), wi))
        cutoff = dist * CUTOFF_SCALE
        lit = visible(boxes, x + RAY_OFFSET * n_shade, wi, cutoff, scatter, st, count_rays)
        le = scene.emission.index_select(0, scene.mat.index_select(0, pick))
        geom = torch.clamp(cos_x, min=0.0) * cos_y / dist2 * total
        contrib = throughput * (a / math.pi) * le * geom[:, None]
        radiance = radiance + torch.where((lit & (total > 0))[:, None], contrib, 0.0)

        new_d = to_world(cosine_hemisphere(u[:, 0], u[:, 1]), n_shade)
        s = scatter[:, None]
        throughput = torch.where(s, throughput * a, throughput)
        o = torch.where(s, point + RAY_OFFSET * n_shade, o)
        d = torch.where(s, new_d, d)
        alive = scatter
        sampled_light = scatter
    return radiance
