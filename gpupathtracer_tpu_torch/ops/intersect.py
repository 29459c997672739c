"""Closest-hit records, the Möller–Trumbore oracle and hit attributes.

Counterpart of ``gpupathtracer_tpu/ops/intersect.py``. ``intersect_brute``
is the brute-force oracle the packed search is checked against: one-sided
triangles accept ``det >= 1e-6``, two-sided ones ``|det| >= 1e-6``, hits
need ``t > 1e-6``, the strictly nearer hit wins and the first row wins ties.
``resolve_hits`` re-derives t, point, normals, barycentrics and UVs from the
winning rows.
"""

from __future__ import annotations

import dataclasses

import torch

from gpupathtracer_tpu_torch.core.tensors import clip, maximum
from gpupathtracer_tpu_torch.models.scene import TriangleScene

EPSILON = 1e-6  # the reference's EPSILON
BIG = 3.0e38  # miss distance


@dataclasses.dataclass(frozen=True)
class Hit:
    """Closest-hit record (SoA)."""

    t: torch.Tensor  # (R,) float32 — world-space distance; BIG on miss
    tri: torch.Tensor  # (R,) int64 — winning scene row, -1 on miss
    hit: torch.Tensor  # (R,) bool


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _mt(o, d, v0, e1, e2, two_sided, t_min: float):
    """Möller–Trumbore on broadcast shapes: o, d (..., 3) against v0, e1,
    e2 (..., 3) and two_sided (...). Returns (t, ok) of the broadcast shape."""
    pvec = torch.linalg.cross(d, e2)
    det = _dot(e1, pvec)
    ok_det = torch.where(two_sided, det.abs() >= EPSILON, det >= EPSILON)
    inv_det = torch.where(det.abs() > 0, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    ok = ok_det & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return t, ok


def mt_block(o, d, v0, e1, e2, two_sided, t_min: float = EPSILON):
    """Möller–Trumbore for all (ray, triangle) pairs of a block.

    o, d: (R, 3); v0, e1, e2: (B, 3); two_sided: (B,). Returns (t, ok): (R, B).
    """
    return _mt(o[:, None, :], d[:, None, :], v0[None], e1[None], e2[None], two_sided[None, :], t_min)


def mt_pairs(o, d, v0, e1, e2, two_sided, t_min: float = EPSILON):
    """Möller–Trumbore for each ray against its own S triangles.

    o, d: (R, 3); v0, e1, e2: (R, S, 3); two_sided: (R, S). Returns (t, ok): (R, S).
    """
    return _mt(o[:, None, :], d[:, None, :], v0, e1, e2, two_sided, t_min)


def intersect_brute(
    o: torch.Tensor,
    d: torch.Tensor,
    scene: TriangleScene,
    tri_block: int = 512,
    t_min: float = EPSILON,
    ray_chunk: int = 8192,
) -> Hit:
    """Brute-force closest hit of rays (R, 3) against every scene triangle:
    triangle blocks stream through a running (best_t, best_index) per ray
    chunk. The search runs on detached rays and geometry."""
    o, d = o.detach(), d.detach()
    v0, e1, e2 = scene.v0.detach(), scene.e1.detach(), scene.e2.detach()
    n = scene.num_triangles
    if n % tri_block:
        raise ValueError(f"scene must be padded to {tri_block}")
    best_t = torch.full((o.shape[0],), BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    for r0 in range(0, o.shape[0], ray_chunk):
        oc, dc = o[r0 : r0 + ray_chunk], d[r0 : r0 + ray_chunk]
        bt, bi = best_t[r0 : r0 + ray_chunk], best_i[r0 : r0 + ray_chunk]
        for start in range(0, n, tri_block):
            rows = slice(start, start + tri_block)
            t, ok = mt_block(oc, dc, v0[rows], e1[rows], e2[rows], scene.two_sided[rows], t_min)
            t = torch.where(ok & scene.valid[rows][None, :], t, BIG)
            blk_min, blk_arg = t.min(dim=-1)  # first index wins ties
            upd = blk_min < bt  # strict <: the earlier block wins ties
            bt.copy_(torch.where(upd, blk_min, bt))
            bi.copy_(torch.where(upd, blk_arg + start, bi))
    return Hit(t=best_t, tri=best_i, hit=best_i >= 0)


@dataclasses.dataclass(frozen=True)
class HitAttributes:
    """Attributes of the winning hit (gathered + re-derived)."""

    t: torch.Tensor  # (R,)
    point: torch.Tensor  # (R, 3) world intersection point
    gn: torch.Tensor  # (R, 3) unit geometric normal
    sn: torch.Tensor | None  # (R, 3) interpolated shading normal
    uv: torch.Tensor | None  # (R, 2) interpolated texture coordinates
    bary: torch.Tensor  # (R, 2) (u, v)
    mat_id: torch.Tensor  # (R,) int64
    geom_id: torch.Tensor  # (R,) int64


def _safe_normalize(x):
    return x / torch.sqrt(maximum((x * x).sum(dim=-1, keepdim=True), 1e-24))


def resolve_hits(
    o, d, scene: TriangleScene, tri: torch.Tensor, need_sn: bool = True, need_uv: bool = True
) -> HitAttributes:
    """Recompute hit attributes for gathered triangles.

    ``tri`` is clamped for the gathers; callers mask with the hit flag.
    ``need_sn=False`` / ``need_uv=False`` skip the shading-normal / UV
    gathers and interpolation (``sn`` / ``uv`` is None).
    """
    idx = torch.clamp(tri, min=0)
    # index_select, not x[idx]: its backward is an index_add_, where that of
    # advanced indexing sorts the indices and sums each row's duplicates in
    # turn (every missed ray gathers row 0).
    rows = lambda x: x.index_select(0, idx)
    v0 = rows(scene.v0)
    e1 = rows(scene.e1)
    e2 = rows(scene.e2)
    pvec = torch.linalg.cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    # Near-parallel gathered rows (clamped indices of missed rays) give huge
    # |t|; clamp far inside the f32 range so later squares stay finite.
    t = clip(_dot(e2, qvec) * inv_det, -1e8, 1e8)
    point = o + t[:, None] * d
    w = 1.0 - u - v
    sn = None
    if need_sn:
        sn = _safe_normalize(
            w[:, None] * rows(scene.n0) + u[:, None] * rows(scene.n1) + v[:, None] * rows(scene.n2)
        )
    uv = None
    if need_uv:
        uv = w[:, None] * rows(scene.uv0) + u[:, None] * rows(scene.uv1) + v[:, None] * rows(scene.uv2)
    return HitAttributes(
        t=t,
        point=point,
        gn=_safe_normalize(torch.linalg.cross(e1, e2)),
        sn=sn,
        uv=uv,
        bary=torch.stack([u, v], dim=-1),
        mat_id=scene.mat_id[idx],
        geom_id=scene.geom_id[idx],
    )
