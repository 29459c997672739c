"""The benchmark's plain path tracer: what every estimator shares, and the
exact float64 search. The estimator is the configuration's
(``render.estimator``), a module of its own, ``reference/<estimator>.py``,
with ``radiance(scene, boxes, albedo, o, d, keys, bounces, count_rays,
stats)``.

Plain PyTorch, importing nothing of the program under test. What it
computes is fixed by the configuration and by the sampling rules the
benchmark holds the program to, written down here once:

- Keys: every path is keyed by (seed, pixel id, sample id, stream) as four
  uint32 words; every draw is one PCG4D evaluation of the key, its top 24
  bits scaled to [0, 1). A stream constant is folded into the key before
  each draw: ``0xA11A`` for the sub-pixel jitter (when spp > 1), the bounce
  index for the scatter.
- Camera: pixel (x, y) plus the jitter maps to ``px = 2 x / W - 1``,
  ``py = 1 - 2 y / H``; the direction is ``normalize((M @ (px, py, 1, 1) *
  far).xyz - position)`` with ``M = inverse(view) @ inverse(projection)``.
- Each bounce finds the closest accepted hit (``closest_hit``): one-sided
  triangles accept a determinant of at least 1e-6, two-sided ones of at
  least 1e-6 in size, at a distance above 1e-6.
- A diffuse hit scatters over the cosine-weighted hemisphere of the
  geometric normal turned against the ray (Duff et al.'s orthonormal
  basis) and restarts 1e-4 along that normal from the hit point.

The shading arithmetic is float32 and follows, operation by operation, the
order in which these rules are usually written, so that a program that
computes the same rules in float32 gives the same bits wherever both find
the same triangle. The search is float64 and exhaustive: a coarse level of
64-triangle boxes (Morton order of the centroids) only prunes, every
triangle in a box the ray enters is tested.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

from h100_bench.reference.scene import RefCamera, RefScene, camera_matrix

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
JITTER_STREAM = 0xA11A
T_MIN = 1e-6
DET_MIN = 1e-6
RAY_OFFSET = 1e-4
BLOCK = 64
# (ray, box) pairs tested at once, PAIR_BATCH x BLOCK triangle tests: about
# 2 GB of float64 temporaries on the card, 130 MB on the CPU.
PAIR_BATCH = {"cuda": 1 << 18, "cpu": 1 << 14}


# ---------------------------------------------------------------- sampling

def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2^32 for words in [0, 2^32) held in int64, from 16-bit
    halves of ``a`` so that no int64 product overflows."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & M32


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    v = (mul32(v, 1664525) + 1013904223) & M32
    x, y, z, w = v.unbind(-1)
    x = (x + mul32(y, w)) & M32
    y = (y + mul32(z, x)) & M32
    z = (z + mul32(x, y)) & M32
    w = (w + mul32(y, z)) & M32
    x, y, z, w = (a ^ (a >> 16) for a in (x, y, z, w))
    x = (x + mul32(y, w)) & M32
    y = (y + mul32(z, x)) & M32
    z = (z + mul32(x, y)) & M32
    w = (w + mul32(y, z)) & M32
    return torch.stack([x, y, z, w], dim=-1)


def path_keys(seed: int, pixels: torch.Tensor, sample: int) -> torch.Tensor:
    n = pixels.shape[0]
    col = lambda c: torch.full((n,), c, dtype=torch.int64, device=pixels.device)
    return torch.stack([col(int(seed) & M32), pixels.to(torch.int64) & M32, col(int(sample) & M32), col(0)], -1)


def fold(keys: torch.Tensor, c: int) -> torch.Tensor:
    stream = (mul32(keys[:, 3], GOLDEN) + (int(c) & M32)) & M32
    return torch.cat([keys[:, :3], stream[:, None]], dim=-1)


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    return (pcg4d(keys)[:, :n] >> 8).to(torch.float32) * (1.0 / 16777216.0)


# ------------------------------------------------------------------ camera

def camera_rays(cam: RefCamera, matrix: np.ndarray, pixels: torch.Tensor, jitter: torch.Tensor | None):
    """Origins and unit directions (float32) through the given pixels."""
    w, h = cam.width, cam.height
    xs = (pixels % w).to(torch.float32)
    ys = torch.div(pixels, w, rounding_mode="floor").to(torch.float32)
    if jitter is not None:
        xs = xs + jitter[:, 0]
        ys = ys + jitter[:, 1]
    px = (xs / float(w)) * 2.0 - 1.0
    py = 1.0 - (ys / float(h)) * 2.0
    clip = torch.stack([px.double(), py.double(), torch.ones_like(px, dtype=torch.float64),
                        torch.ones_like(px, dtype=torch.float64)], -1) * cam.far
    m = torch.as_tensor(matrix, dtype=torch.float64, device=pixels.device)
    pos = torch.as_tensor(cam.position, dtype=torch.float64, device=pixels.device)
    d = (clip @ m.T)[:, :3] - pos
    d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).to(torch.float32)
    return pos.to(torch.float32).expand_as(d), d


# ------------------------------------------------------------------ search

@dataclasses.dataclass
class Boxes:
    """The search's coarse level: triangles in Morton order of their
    centroids, cut into ``BLOCK``-triangle boxes. Slot ``T`` of the float64
    copies is an all-zero triangle (never accepted) that pads the last box."""

    v0: torch.Tensor  # (T + 1, 3) float64
    e1: torch.Tensor
    e2: torch.Tensor
    two_sided: torch.Tensor  # (T + 1,)
    order: torch.Tensor  # (NB, BLOCK) triangle rows of each box, T = padding
    lo: torch.Tensor  # (NB, 3) box corners, float64, widened a little
    hi: torch.Tensor
    tri_lo: torch.Tensor  # (T + 1, 3) each triangle's own box
    tri_hi: torch.Tensor
    count: int  # T


def _morton(q: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code of 10-bit integer coordinates (N, 3)."""
    code = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


def build_boxes(scene: RefScene) -> Boxes:
    dev = scene.v0.device
    v0, e1, e2 = scene.v0.double(), scene.e1.double(), scene.e2.double()
    corners = torch.stack([v0, v0 + e1, v0 + e2], 1)
    t_lo, t_hi = corners.amin(1), corners.amax(1)
    cen = corners.mean(1)
    s_lo, s_hi = t_lo.amin(0), t_hi.amax(0)
    q = ((cen - s_lo) / torch.clamp(s_hi - s_lo, min=1e-30) * 1023).clamp(0, 1023).to(torch.int64)
    # Triangles far larger than the median (the planes) sort behind the
    # rest, so that they widen no box of small ones.
    diag = torch.linalg.norm(t_hi - t_lo, dim=-1)
    big = (diag > 8 * diag.median()).to(torch.int64)
    order = torch.argsort(big * (1 << 31) + _morton(q), stable=True)
    t = scene.num_triangles
    nb = -(-t // BLOCK)
    order = torch.cat([order, torch.full((nb * BLOCK - t,), t, dtype=torch.int64, device=dev)]).reshape(nb, BLOCK)
    pad = lambda x, fill=0.0: torch.cat([x, torch.full((1,) + x.shape[1:], fill, dtype=x.dtype, device=dev)])
    # Padding's box is empty (lo > hi): it widens no block's box.
    tri_lo, tri_hi = pad(t_lo, math.inf), pad(t_hi, -math.inf)
    lo, hi = tri_lo[order].amin(1), tri_hi[order].amax(1)
    widen = 1e-9 * float(torch.clamp(s_hi - s_lo, min=1.0).max())
    return Boxes(v0=pad(v0), e1=pad(e1), e2=pad(e2), two_sided=pad(scene.two_sided, False), order=order,
                 lo=lo - widen, hi=hi + widen, tri_lo=tri_lo, tri_hi=tri_hi, count=t)


def _slab(o, inv_d, lo, hi):
    """Entry and exit distances of rays (.., 3) into boxes (.., 3)."""
    t1, t2 = (lo - o) * inv_d, (hi - o) * inv_d
    return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)


def _inv(d):
    return 1.0 / torch.where(d == 0, 1e-300, d)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _box_pairs(boxes: Boxes, o, inv_d, t_end):
    """(ray, box) pairs whose box the ray enters at a distance in [0, t_end]."""
    nb = boxes.lo.shape[0]
    chunk = max(1, (1 << 23) // nb)
    rays, blocks = [], []
    for r0 in range(0, o.shape[0], chunk):
        sl = slice(r0, r0 + chunk)
        near, far = _slab(o[sl, None], inv_d[sl, None], boxes.lo[None], boxes.hi[None])
        ri, bi = torch.nonzero((near <= far) & (far >= 0) & (near <= t_end[sl, None]), as_tuple=True)
        rays.append(ri + r0)
        blocks.append(bi)
    return torch.cat(rays), torch.cat(blocks)


def closest_hit(boxes: Boxes, o32: torch.Tensor, d32: torch.Tensor):
    """Exact closest hit of float32 rays, in float64: ``(tri, t)``, tri = -1
    and t = inf on a miss. Of two hits at the same distance the lower row wins."""
    o, d = o32.double(), d32.double()
    inv_d = _inv(d)
    n = o.shape[0]
    best_t = torch.full((n,), math.inf, dtype=torch.float64, device=o.device)
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    ri_all, bi_all = _box_pairs(boxes, o, inv_d, torch.full_like(best_t, math.inf))
    step = PAIR_BATCH[o.device.type]
    for p0 in range(0, ri_all.shape[0], step):
        ri, bi = ri_all[p0:p0 + step], bi_all[p0:p0 + step]
        rows = boxes.order[bi]  # (P, BLOCK)
        v0, e1, e2 = boxes.v0[rows], boxes.e1[rows], boxes.e2[rows]
        oo, dd = o[ri][:, None], d[ri][:, None]
        pvec = _cross(dd, e2)
        det = (e1 * pvec).sum(-1)
        det_ok = torch.where(boxes.two_sided[rows], det.abs() >= DET_MIN, det >= DET_MIN)
        inv_det = 1.0 / torch.where(det == 0, 1.0, det)
        tvec = oo - v0
        u = (tvec * pvec).sum(-1) * inv_det
        qvec = _cross(tvec, e1)
        v = (dd * qvec).sum(-1) * inv_det
        t = (e2 * qvec).sum(-1) * inv_det
        ok = det_ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN)
        t = torch.where(ok, t, math.inf)
        pt, arg = t.min(-1)
        ptri = torch.where(torch.isfinite(pt), rows.gather(1, arg[:, None])[:, 0], n)
        new_t = best_t.scatter_reduce(0, ri, pt, "amin")
        win = (pt == new_t[ri]) & torch.isfinite(pt)
        cand = torch.full_like(best_tri, torch.iinfo(torch.int64).max)
        cand = cand.scatter_reduce(0, ri[win], ptri[win], "amin")
        improved = new_t < best_t
        tie = (new_t == best_t) & torch.isfinite(new_t)
        best_tri = torch.where(improved, cand, torch.where(tie, torch.minimum(best_tri, cand), best_tri))
        best_t = new_t
    return best_tri, best_t


def boxes_entered(boxes: Boxes, o32: torch.Tensor, d32: torch.Tensor, t_end: torch.Tensor) -> torch.Tensor:
    """Per ray, how many scene triangles have an axis-aligned box that the
    ray enters at a distance in [0, t_end] (t_end = inf for a miss: every
    box lies inside the scene's, so that is the same as before the ray
    leaves the scene's box). A triangle's box lies inside its block's box,
    so only the blocks the ray enters are looked into."""
    o, d = o32.double(), d32.double()
    inv_d = _inv(d)
    count = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    ri_all, bi_all = _box_pairs(boxes, o, inv_d, t_end)
    step = PAIR_BATCH[o.device.type]
    for p0 in range(0, ri_all.shape[0], step):
        ri, bi = ri_all[p0:p0 + step], bi_all[p0:p0 + step]
        rows = boxes.order[bi]
        near, far = _slab(o[ri][:, None], inv_d[ri][:, None], boxes.tri_lo[rows], boxes.tri_hi[rows])
        inside = (near <= far) & (far >= 0) & (near <= t_end[ri][:, None]) & (rows < boxes.count)
        count.index_add_(0, ri, inside.sum(-1))
    return count


# ------------------------------------------------------------------ shading
# float32, in the order the rules are written (see the module docstring).

def _safe_normalize(x):
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=-1, keepdim=True), min=1e-24))


def _dot(a, b):
    return (a * b).sum(dim=-1)


def hit_point_and_normal(o, d, scene: RefScene, tri: torch.Tensor):
    """The hit point ``o + t d`` with t re-derived in float32 from the row's
    edges, and the row's unit geometric normal."""
    idx = torch.clamp(tri, min=0)
    v0, e1, e2 = scene.v0[idx], scene.e1[idx], scene.e2[idx]
    pvec = torch.linalg.cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    tvec = o - v0
    qvec = torch.linalg.cross(tvec, e1)
    t = torch.clamp(_dot(e2, qvec) * inv_det, -1e8, 1e8)
    return o + t[:, None] * d, _safe_normalize(torch.linalg.cross(e1, e2))


def cosine_hemisphere(u1, u2):
    r = torch.sqrt(u1)
    theta = 2.0 * math.pi * u2
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)


def to_world(local, n):
    """Duff et al. 2017's branchless basis around the unit normal n."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    t = torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], dim=-1)
    bv = torch.stack([b, sign + y * y * a, -y], dim=-1)
    return local[..., 0:1] * t + local[..., 1:2] * bv + local[..., 2:3] * n


# ------------------------------------------------------------------ paths

@dataclasses.dataclass
class BounceStats:
    """What the reference saw at one bounce of the traced paths."""

    lanes: int = 0  # paths traced
    live: int = 0  # paths still alive at this bounce (rays searched)
    counted: int = 0  # live rays whose box crossings were counted
    tests: int = 0  # their box crossings (``boxes_entered``)


def search(boxes: Boxes, o, d, alive, stats: BounceStats | None = None, count_rays: int = 0):
    """The closest hit of every ``alive`` ray, ``tri`` (-1 for a miss or a
    ray that is not alive). Counts into ``stats`` the paths, the live rays
    and the box crossings of ``count_rays`` live rays spread evenly over
    them."""
    n = o.shape[0]
    live = torch.nonzero(alive).flatten()
    tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    t_hit = None
    if live.numel():
        tri_live, t_hit = closest_hit(boxes, o[live], d[live])
        tri[live] = tri_live
    if stats is not None:
        stats.lanes += n
        stats.live += int(live.numel())
        if count_rays and live.numel():
            # Every stride-th live ray: a sample spread over the whole
            # image, as the pixels are in raster order.
            pick = torch.arange(0, live.numel(), max(1, live.numel() // count_rays), device=o.device)[:count_rays]
            k = live[pick]
            stats.counted += int(k.numel())
            stats.tests += int(boxes_entered(boxes, o[k], d[k], t_hit[pick]).sum())
    return tri


def load_estimator(name: str):
    """The module ``reference/<name>.py`` of an estimator."""
    try:
        return importlib.import_module(f"{__package__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.{name}":
            raise
        raise ValueError(f"the reference has no {name!r} estimator (reference/{name}.py)") from e


def trace_pixels(scene: RefScene, boxes: Boxes, cam: RefCamera, pixels: torch.Tensor, seed: int, spp: int,
                 bounces: int, jitter: bool = True, albedo: torch.Tensor | None = None, count_rays: int = 0,
                 stats: list | None = None, first_sample: int = 0, estimator: str = "naive") -> torch.Tensor:
    """The radiance summed over samples ``first_sample`` .. ``+ spp - 1`` of
    the given pixels, (P, 3) float32, in sample order, by the estimator
    ``reference/<estimator>.py``. ``albedo`` replaces the scene's (a tensor
    that may require a gradient). The box crossings of ``count_rays`` live
    rays of each bounce of each sample, spread evenly over the live ones,
    are added to ``stats`` (one ``BounceStats`` per bounce)."""
    radiance = load_estimator(estimator).radiance
    matrix = camera_matrix(cam)
    albedo = scene.albedo if albedo is None else albedo
    film = torch.zeros((pixels.shape[0], 3), dtype=torch.float32, device=pixels.device)
    for s in range(first_sample, first_sample + spp):
        keys = path_keys(seed, pixels, s)
        ju = uniform(fold(keys, JITTER_STREAM), 2) if jitter and spp > 1 else None
        o, d = camera_rays(cam, matrix, pixels, ju)
        film = film + radiance(scene, boxes, albedo, o, d, keys, bounces, count_rays, stats)
    return film
