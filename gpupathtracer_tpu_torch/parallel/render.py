"""Distributed rendering over the ("data", "scene") process mesh.

Counterpart of ``gpupathtracer_tpu/parallel/render.py`` (there a
``shard_map``; here one process per rank, SPMD):

- **data**: each rank renders a row-major slice of the pixels. Sample keys
  depend only on (seed, pixel id, sample id), so the slices together equal
  ``render_frame``'s frame.
- **scene**: triangle rows are sharded; shard s holds rows
  [s·K, (s+1)·K). Only the closest-hit search reads the shard. Shading,
  emission and NEE's light table read the full scene, which every rank
  holds. Three strategies resolve the closest hit across shards:
  "allgather" (local search, an all-gather of (t, global row) over
  ``scene`` and a first-wins argmin: ties go to the lower shard, that is
  the lower row), "ring" (row shards rotate around ``scene`` with
  send/recv; the fold takes strictly nearer hits and, at equal t, the lower
  global row) and "ulysses" (pixels sharded over both axes, rays
  all-gathered over ``scene``, the partial hits sent back with one
  all-to-all, first-wins argmin).

A shard's search is the renderer's: the packed kernels (K1/K2 on a
resident shard pack, K3 on a streamed one) or their plain versions on CPU
tensors. Shadow rays threshold the sharded closest hit. With one scene
shard (pure data parallel) the renderer's packs are used as they are,
including the second pack of the scan bounces and its any-hit search.

The frame is differentiable in the scene's and the camera's tensors on
every rank: the slices are gathered with a gather whose backward keeps the
rank's own slice, and each tensor that requires a gradient passes an
identity whose backward sums the gradient over the pixel shards, so every
rank gets ``render_frame``'s gradient of the same loss.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gpupathtracer_tpu_torch.core.tensors import resolve_device
from gpupathtracer_tpu_torch.models.camera import Camera
from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops import packed_intersect
from gpupathtracer_tpu_torch.ops.intersect import BIG, Hit
from gpupathtracer_tpu_torch.ops.sampling import prng_key_data
from gpupathtracer_tpu_torch.parallel.multihost import all_gather, all_reduce, all_to_all, shift
from gpupathtracer_tpu_torch.render.integrator import check_supported, make_intersect_fn
from gpupathtracer_tpu_torch.render.renderer import (
    RenderSettings,
    _integrator_options,
    accumulate_radiance,
    narrow_settings,
)
from gpupathtracer_tpu_torch.utils.debug import check_frame

_ROW_FIELDS = (
    "v0", "e1", "e2", "gn", "gn_ref", "n0", "n1", "n2",
    "uv0", "uv1", "uv2", "geom_id", "mat_id", "two_sided", "valid",
)
# The rows a closest-hit search reads; the ring rotates only these.
_SEARCH_FIELDS = ("v0", "e1", "e2", "two_sided", "valid")
STRATEGIES = ("allgather", "ring", "ulysses")


def shard_scene_rows(scene: TriangleScene, n_scene: int) -> dict:
    """The triangle row tensors reshaped (N, ...) → (n_scene, N/n_scene, ...)."""
    n = scene.num_triangles
    assert n % n_scene == 0, f"triangle count {n} not divisible by scene axis {n_scene}"
    return {f: getattr(scene, f).reshape(n_scene, n // n_scene, *getattr(scene, f).shape[1:]) for f in _ROW_FIELDS}


def scene_shard(scene: TriangleScene, n_scene: int, index: int) -> TriangleScene:
    """The scene with its triangle rows cut to shard ``index`` of
    ``n_scene``: what a rank at that place on the scene axis searches."""
    rows = shard_scene_rows(scene, n_scene)
    return dataclasses.replace(scene, **{f: r[index] for f, r in rows.items()})


def _global_rows(h: Hit, offset: int) -> torch.Tensor:
    return torch.where(h.tri >= 0, h.tri + offset, -1)


def _first_wins(t_all: torch.Tensor, i_all: torch.Tensor) -> Hit:
    """The closest of S candidates (S, R) per ray; the first shard wins ties."""
    s = torch.argmin(t_all, dim=0)[None]
    best_i = i_all.gather(0, s)[0]
    return Hit(t=t_all.gather(0, s)[0], tri=best_i, hit=best_i >= 0)


def make_scene_sharded_intersect(local_scene: TriangleScene, rows_per_shard: int, options, group):
    """Closest hit across ``scene``: local search, all-gather of the
    candidates, first-wins argmin."""
    local_fn = make_intersect_fn(local_scene, options)
    offset = dist.get_rank(group) * rows_per_shard

    def intersect(o, d, alive=None) -> Hit:
        h = local_fn(o, d, alive=alive)
        t_all = torch.stack(all_gather(h.t, group))
        i_all = torch.stack(all_gather(_global_rows(h, offset), group))
        return _first_wins(t_all, i_all)

    return intersect


def make_ring_intersect(local_scene: TriangleScene, rows_per_shard: int, n_scene: int, options, group):
    """Closest hit across ``scene`` by ring rotation: rays stay, the row
    shards (the fields the search reads) move one hop per step, and a
    running (t, global row) folds each shard's hits: strictly nearer wins,
    an equal t goes to the lower global row, whatever the visiting order."""
    me = dist.get_rank(group)
    rows0 = {f: getattr(local_scene, f).detach() for f in _SEARCH_FIELDS}

    def intersect(o, d, alive=None) -> Hit:
        best_t = torch.full((o.shape[0],), BIG, dtype=torch.float32, device=o.device)
        best_i = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
        rows = rows0
        for k in range(n_scene):
            if k:
                rows = shift(rows, group)
            holder = (me - k) % n_scene  # whose rows this rank holds now
            scene_k = dataclasses.replace(local_scene, **rows)
            h = make_intersect_fn(scene_k, options)(o, d, alive=alive)
            tri_g = _global_rows(h, holder * rows_per_shard)
            take = h.hit & ((h.t < best_t) | ((h.t == best_t) & ((best_i < 0) | (tri_g < best_i))))
            best_t = torch.where(take, h.t, best_t)
            best_i = torch.where(take, tri_g, best_i)
        return Hit(t=best_t, tri=best_i, hit=best_i >= 0)

    return intersect


def make_ulysses_intersect(local_scene: TriangleScene, rows_per_shard: int, n_scene: int, options, group):
    """Closest hit across ``scene`` by resharding the rays: each rank's rays
    are all-gathered over ``scene`` (every shard searches the group's
    rays), the candidates go back to the rays' owners with one all-to-all,
    and a first-wins argmin over the shards resolves them."""
    local_fn = make_intersect_fn(local_scene, options)
    offset = dist.get_rank(group) * rows_per_shard

    def intersect(o, d, alive=None) -> Hit:
        r_local = o.shape[0]
        o_all = torch.cat(all_gather(o.detach(), group))
        d_all = torch.cat(all_gather(d.detach(), group))
        alive_all = None if alive is None else torch.cat(all_gather(alive, group))
        h = local_fn(o_all, d_all, alive=alive_all)
        t_all = all_to_all(h.t, group).reshape(n_scene, r_local)
        i_all = all_to_all(_global_rows(h, offset), group).reshape(n_scene, r_local)
        return _first_wins(t_all, i_all)

    return intersect


class _GatherRows(torch.autograd.Function):
    """Forward: the group's slices concatenated in rank order. Backward: the
    rank's own slice of the gradient (the sum over ranks is taken at the
    leaves, ``_SumGrads``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return torch.cat(all_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g[me * ctx.n : (me + 1) * ctx.n], None


class _SumGrads(torch.autograd.Function):
    """Identity on the tensors; the backward sums their gradients over the
    group in one all-reduce (every rank calls it once per backward pass,
    so the collectives line up)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        full = [torch.zeros(s, dtype=t, device=dv) if g is None else g for g, (s, t, dv) in zip(grads, ctx.meta)]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in full]), ctx.group)
        parts = torch.split(flat, [g.numel() for g in full])
        return (None, *(x.reshape(g.shape) for x, g in zip(parts, full)))


def _grad_leaves(obj, prefix=()):
    """(path, tensor) of every tensor field that requires a gradient in a
    dataclass and its nested dataclasses."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) and v.requires_grad:
            out.append((prefix + (f.name,), v))
        elif dataclasses.is_dataclass(v):
            out += _grad_leaves(v, prefix + (f.name,))
    return out


def _replace_at(obj, path, value):
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    return dataclasses.replace(obj, **{path[0]: _replace_at(getattr(obj, path[0]), path[1:], value)})


def _sum_grads_over(group, scene, camera):
    """The scene and camera with every tensor that requires a gradient
    passed through one ``_SumGrads``."""
    both = {"scene": scene, "camera": camera}
    leaves = [((name,) + p, t) for name, obj in both.items() for p, t in _grad_leaves(obj)]
    if not leaves or dist.get_world_size(group) == 1:
        return scene, camera
    for (path, _), t in zip(leaves, _SumGrads.apply(group, *(t for _, t in leaves))):
        both[path[0]] = _replace_at(both[path[0]], path[1:], t)
    return both["scene"], both["camera"]


def render_frame_distributed(
    scene: TriangleScene,
    camera: Camera,
    settings: RenderSettings,
    mesh,
    seed: int | None = None,
    scene_strategy: str = "allgather",
    device="cuda",
) -> torch.Tensor:
    """This rank's part of a distributed render, on ``device`` (the card
    unless the caller passes ``device="cpu"``); returns the full (H, W, 3)
    mean-radiance frame on every rank, equal to ``render_frame``'s.

    ``mesh`` is a ``parallel.mesh.make_mesh`` mesh over every rank. Pixels
    shard over ``data`` (over both axes for "ulysses"); with more than one
    scene shard, ``scene_strategy`` picks how the closest hit is resolved
    across them (module docstring). ``narrow_settings`` runs on the full
    scene, before sharding; the triangle count must divide by the scene
    axis and the pixel count by the pixel shards. Radiance only."""
    if scene_strategy not in STRATEGIES:
        raise ValueError(f"unknown scene_strategy {scene_strategy!r}")
    if settings.aov != "radiance":
        raise ValueError(f"render_frame_distributed renders radiance, not aov {settings.aov!r}")
    if (camera.width, camera.height) != (settings.width, settings.height):
        raise ValueError("camera/screen size mismatch")
    device = resolve_device(device)
    ranks = mesh.mesh
    n_data, n_scene = ranks.shape
    if ranks.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("the mesh must hold every rank of the process group, in order")
    i_data, i_scene = mesh.get_local_rank("data"), mesh.get_local_rank("scene")
    h, w = settings.height, settings.width
    r = h * w
    ulysses = scene_strategy == "ulysses" and n_scene > 1
    n_pix = n_data * n_scene if ulysses else n_data
    if r % n_pix:
        raise ValueError(f"pixels {r} not divisible by {n_pix} pixel shards")
    pix_group = dist.group.WORLD if ulysses else mesh.get_group("data")
    shard = i_data * n_scene + i_scene if ulysses else i_data
    r_local = r // n_pix

    scene, camera = scene.to(device), camera.to(device)
    settings = narrow_settings(scene, settings)  # the full scene's, before sharding
    opts = _integrator_options(settings)
    check_supported(opts)
    packed = packed2 = intersect_fn = None
    if n_scene == 1:
        # Pure data parallel: the renderer's packs of the full scene.
        if settings.intersector not in ("brute", "bvh"):
            packed = packed_intersect.pack_scene(scene, tri_block=settings.tri_block)
            if settings.tri_block_secondary is not None and settings.bounces > 1:
                packed2 = packed_intersect.pack_scene(scene, tri_block=settings.tri_block_secondary)
    else:
        local = scene_shard(scene, n_scene, i_scene)
        per = scene.num_triangles // n_scene
        group = mesh.get_group("scene")
        if ulysses:
            intersect_fn = make_ulysses_intersect(local, per, n_scene, opts, group)
        elif scene_strategy == "ring":
            intersect_fn = make_ring_intersect(local, per, n_scene, opts, group)
        else:
            intersect_fn = make_scene_sharded_intersect(local, per, opts, group)
    # Packs and shards come from the scene as given (the packs of the full
    # scene are cached across frames; a shard's views are new tensors, so
    # its pack is made again each frame); shading reads the scene through
    # the gradient sum.
    scene, camera = _sum_grads_over(pix_group, scene, camera)
    pixel_idx = torch.arange(shard * r_local, (shard + 1) * r_local, device=device)
    key_data = prng_key_data(settings.seed if seed is None else seed)
    film_sum = accumulate_radiance(scene, camera, pixel_idx, settings, key_data, packed=packed,
                                   packed_secondary=packed2, intersect_fn=intersect_fn)
    frame = _GatherRows.apply(film_sum / settings.spp, pix_group)
    return check_frame(frame.reshape(h, w, 3), "render_frame_distributed")
