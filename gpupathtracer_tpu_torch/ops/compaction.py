"""Ray-stream compaction: live lanes first, dead lanes parked outside the scene.

Counterpart of ``gpupathtracer_tpu/ops/compaction.py`` (permute mode).
``partition_alive`` is a stable alive-first permutation from two cumsums;
``compact_rays`` permutes the rays with it and parks dead lanes on a ray far
outside the scene pointing away, so whole tiles of dead lanes fail the
tile×block frustum test and cost the kernel nothing.
``compact_rays_coherent`` does the same with one stable sort that also
groups live rays by direction octant and Morton codes (ray sorting).
"""

from __future__ import annotations

import torch

# A parked ray: far outside any practical scene, pointing further away.
DEAD_ORIGIN = (3.0e7, 3.0e7, 3.0e7)
DEAD_DIR = (0.577350269, 0.577350269, 0.577350269)


def morton_codes(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """10-bit-per-axis Morton codes (30 bits, in int64) of ``points`` (N, 3)
    in the box [lo, hi]: the sort key of the packed rows and of the rays."""
    span = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((points - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)

    def spread(x):  # interleave 10 bits with 2-bit gaps
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def partition_alive(alive: torch.Tensor):
    """Stable alive-first permutation ``(perm, inv)``: ``x[perm]`` lists live
    lanes first (original order kept within each class) and ``y[inv]`` undoes
    it."""
    alive_i = alive.to(torch.int64)
    n_alive = alive_i.sum()
    rank_alive = torch.cumsum(alive_i, 0) - 1
    rank_dead = torch.cumsum(1 - alive_i, 0) - 1
    inv = torch.where(alive, rank_alive, n_alive + rank_dead)  # new position of lane i
    perm = torch.empty_like(inv)
    perm[inv] = torch.arange(inv.shape[0], device=inv.device)
    return perm, inv


def compact_rays(o: torch.Tensor, d: torch.Tensor, alive: torch.Tensor):
    """Permute rays alive-first and park dead lanes on the far ray.

    Returns ``(o_c, d_c, inv)``; gather results with ``res[inv]``.
    """
    perm, inv = partition_alive(alive)
    o_c, d_c = _permute_and_park(o, d, alive, perm)
    return o_c, d_c, inv


def _permute_and_park(o, d, alive, perm):
    """``(o_c, d_c)``: the rays in ``perm`` order, dead lanes parked on the far
    ray. The gathers are index_select, whose backward is an index_add_."""
    alive_c = alive[perm][:, None]
    o_c = torch.where(alive_c, o.index_select(0, perm), o.new_tensor(DEAD_ORIGIN))
    d_c = torch.where(alive_c, d.index_select(0, perm), d.new_tensor(DEAD_DIR))
    return o_c, d_c


def compact_rays_coherent(o: torch.Tensor, d: torch.Tensor, alive: torch.Tensor, key_mode: str = "dir"):
    """Compaction and a coherence sort in one stable permutation, as the JAX
    package's ``compact_rays_coherent``. The int64 key is, from the most
    significant field down: the dead flag (bit 31), the direction octant,
    then for ``"dir"`` the top 12 bits of the direction Morton code and the
    top 12 of the origin's, for ``"origin"`` the top 15 of the origin's and
    the top 13 of the direction's. The origin box is the live origins'
    (0 and 1 when there are none). Dead lanes park on the far ray as in
    ``compact_rays``.

    The key is built from detached rays; the gathers ``o[perm]`` and
    ``d[perm]`` stay differentiable.

    Returns ``(o_c, d_c, inv)``; gather results with ``res[inv]``.
    """
    if key_mode not in ("dir", "origin"):
        raise ValueError(f"unknown sort key {key_mode!r}")
    od, dd = o.detach(), d.detach()
    octant = (dd[:, 0] < 0).long() + 2 * (dd[:, 1] < 0).long() + 4 * (dd[:, 2] < 0).long()
    dm = morton_codes(dd, dd.new_full((3,), -1.0), dd.new_full((3,), 1.0))
    # nanmin / nanmax over the live origins.
    use = alive[:, None] & ~torch.isnan(od)
    lo = torch.where(use, od, torch.inf).amin(dim=0)
    hi = torch.where(use, od, -torch.inf).amax(dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    om = morton_codes(od, lo, hi)
    dead = (~alive).long() << 31
    if key_mode == "origin":
        key = dead | (octant << 28) | ((om >> 15) << 13) | (dm >> 17)
    else:
        key = dead | (octant << 28) | ((dm >> 18) << 16) | ((om >> 18) << 4)
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    o_c, d_c = _permute_and_park(o, d, alive, perm)
    return o_c, d_c, inv
