"""Packed ray search: scene packing, tile×block culling, the front-to-back
schedule, and the closest-hit and any-hit kernels with their plain versions.

Counterpart of ``gpupathtracer_tpu/ops/pallas_intersect.py``. The scene is
packed one-sided: two-sided rows are appended again with flipped winding,
rows are sorted by a stable 30-bit Morton code of their centroids (dead rows
at the tail) and cut into blocks of ``tri_block`` rows, each with an AABB.
For each tile of ``ray_tile`` rays an interval frustum test culls blocks and
lower-bounds the hit distance into each survivor (``tile_block_mask``);
``plan_block_order`` sorts the survivors front to back.

Two routes, chosen per pack as the JAX package chooses them (``route``, which
the renderer's sort autos also follow): a pack of at most
``RESIDENT_BUDGET_BYTES`` takes the resident route, a larger one the
streamed route. ``prepare`` makes a search's inputs on either route: with
the torch ops below on CPU tensors (and for the plain versions), and in one
launch of ``csrc/schedule.cu`` (``ops/schedule.py``), the same to the bit,
on CUDA tensors (``schedule_route``). The
streamed route pads the blocks to a multiple of ``bpc`` (blocks per
cluster, about ``CLUSTER_TARGET_BYTES`` each), schedules whole
clusters front to back, skips single blocks inside a cluster by their own
entry bound, and uses ``STREAM_RAY_TILE``-ray tiles unless the caller pins a
width. Four searches walk the schedules with early exit:

- ``closest_hit`` (``csrc/closest_hit.cu``) and ``closest_hit_streamed``
  (``csrc/closest_hit_streamed.cu``): the nearest accepted hit;
- ``occluded`` (``csrc/occlusion.cu``) and ``occluded_streamed``
  (``csrc/occlusion_streamed.cu``): whether any accepted hit lies before a
  per-ray cutoff ``max_t`` (shadow rays; no division).

On a CUDA tensor each launches its kernel (through ``_build.launch``, which
counts the launches by library); on a CPU tensor it runs its plain PyTorch
version (the same name with ``_reference``); one body, ``_search``, serves
all four. All four kernels read only the ``LIVE_SLOTS`` of ``w``
(``ops/plucker.py``), so every wrapper takes only the ``w`` of a pack
marked ``live_slots_only``, on every device:
``pack_scene`` marks its packs, and ``mark_live_slots`` marks a pack built
elsewhere (one carried from the JAX package) once it has checked the zeros.

Every search takes the decision product's ``precision``, one of the JAX
package's modes (``PRECISIONS``; "auto" resolves to "highest"). The
streamed closest hit also has the JAX package's traversal modes, all off by
default (``STREAM_PHASE1_BUDGET``, ``STREAM_SUBTILES``,
``STREAM_FRESH_WORST``): seeded lanes, a cap on the clusters a tile visits
with a per-lane ``done`` flag, and the straggler regroup in
``intersect_packed`` that resumes the undone lanes in fresh tiles. They
change the work, never the hits.

The closest-hit searches and the streamed any-hit search take a test
counter, ``tests`` (an int64 tensor of one element, or None): they add to
it the (live lane, triangle column) tests they compute, the kernels on the
device and the plain versions from their ``count_work`` count.
``intersect_packed`` passes the traced frame's closest-hit counter
(``utils.profiling.frame_tests``), ``intersect_packed_occluded`` on the
streamed route its any-hit counter (``frame_anyhit_tests``); both open the
``render.schedule`` and ``render.search.*`` spans.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gpupathtracer_tpu_torch.core.tensors import TensorCache, to_device
from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops import _build, schedule
from gpupathtracer_tpu_torch.ops.compaction import morton_codes, partition_alive
from gpupathtracer_tpu_torch.ops.intersect import BIG, EPSILON, Hit
from gpupathtracer_tpu_torch.ops.plucker import K, LIVE_SLOTS, NSCALARS, pack_rays
from gpupathtracer_tpu_torch.utils.profiling import frame_anyhit_tests, frame_tests, scope

DEFAULT_RAY_TILE = 128
INF = float("inf")

# Route choice and streamed shapes, the JAX package's values; read at call
# time, so a test may patch them. Packs of at most RESIDENT_BUDGET_BYTES
# take the resident route. The streamed route groups blocks into clusters of
# about CLUSTER_TARGET_BYTES and tiles rays by STREAM_RAY_TILE.
RESIDENT_BUDGET_BYTES = 16 * 1024 * 1024
CLUSTER_TARGET_BYTES = 1024 * 1024
STREAM_RAY_TILE = 64

# A search's schedule has two routes (``schedule_route``), which the
# render.schedule span records by index: the torch ops, and one launch of
# csrc/schedule.cu (``ops/schedule.py``).
SCHEDULE_ROUTES = ("ops", "kernel")

# The streamed closest hit's traversal modes, the JAX package's, all off by
# default and read at call time. STREAM_PHASE1_BUDGET > 0 caps the clusters
# a tile visits; the lanes that cap leaves undone are regrouped densely and
# resumed from their partial hits (intersect_packed). STREAM_SUBTILES > 1
# gates each block on the running worst of each group of ray_tile /
# STREAM_SUBTILES lanes; STREAM_FRESH_WORST gates each block of a cluster on
# the tile's running worst instead of the cluster-start one. Entry bounds
# are lower bounds and updates strict <, so every mode gives the same hits.
STREAM_PHASE1_BUDGET = 0
STREAM_SUBTILES = 1
STREAM_FRESH_WORST = False

# The decision product's precision, the JAX package's modes
# (``_decision_dot``), in the order of csrc/stream_stage.cuh's Precision:
# "highest" f32; "high" three bf16 products of hi/lo splits,
# d(fh, wh) + (d(fh, wl) + d(fl, wh)) summed in f32; "mixed" "high" for the
# edge columns s0|s1|s2 and f32 for D|num; "default" one bf16 product.
PRECISIONS = ("highest", "high", "mixed", "default")


def resolve_precision(precision: str) -> str:
    """A mode of ``PRECISIONS``: "auto" resolves to "highest" (the JAX
    package resolves it to "mixed" only on a TPU); anything else not in
    ``PRECISIONS`` raises ValueError."""
    if precision == "auto":
        return "highest"
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: 'auto' or one of {', '.join(map(repr, PRECISIONS))}")
    return precision


def split_bf16(x: torch.Tensor):
    """``(hi, lo)`` of float32 ``x`` as float32 tensors of bf16 values:
    hi = bf16(x) and lo = bf16(x - hi), both rounded to nearest even, as
    the JAX package's ``_dot_high`` splits its operands (x - hi is exact in
    float32). A product of two bf16 values is exact in float32."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


# The tensor-core route of the bf16 modes (K1-K4; csrc/stream_stage.cuh):
# each decision scalar multiplies one window of MMA_WINDOW feature rows,
# starting at its MMA_WINDOW_START row (s0, s1, s2 and D rows 0-7, num rows
# 6-13). Every live slot of a scalar lies in its window, and every other
# row of a window is 0 in w.
MMA_WINDOW = 8
MMA_WINDOW_START = (0, 0, 0, 0, 6)


def mma_windows(x: torch.Tensor) -> torch.Tensor:
    """(nb, NSCALARS, tb, MMA_WINDOW) of ``x`` (nb, K, NSCALARS·tb): for
    each block, scalar s and column c, the feature rows of s's window,
    contiguous."""
    nb, _, five_tb = x.shape
    cols = x.view(nb, K, NSCALARS, five_tb // NSCALARS).permute(0, 2, 3, 1)
    return torch.stack([cols[:, s, :, k0 : k0 + MMA_WINDOW] for s, k0 in enumerate(MMA_WINDOW_START)], dim=1)


def _kernel_operands(w: torch.Tensor, precision: str):
    """The triangle operands the kernels stage for ``precision``:
    ``(w, hi, lo)``. For the bf16 modes (the tensor-core route), hi =
    bf16(w) and lo = bf16(w - bf16(w)) as ``torch.bfloat16``
    ``mma_windows`` of ``split_bf16(w)``: "default" reads hi (lo is hi),
    "high" hi and lo, "mixed" hi and lo of s0-s2 and the f32 D|num rows of
    ``w``. "highest" gets ``(w, w, w)`` and reads ``w`` only.

    Split once per ``w`` for all three modes and all four searches, and
    cached on it keyed on its version counter, as the live-slot mark is."""
    if precision == "highest":
        return w, w, w
    cached = getattr(w, "_kernel_operands", None)
    if cached is None or cached[0] != w._version:
        hi, lo = (mma_windows(x).to(torch.bfloat16) for x in split_bf16(w))
        cached = w._kernel_operands = (w._version, hi, lo)
    _, hi, lo = cached
    return w, hi, hi if precision == "default" else lo


# Launch shape of the four kernels' "highest" instantiations
# (csrc/stream_stage.cuh), per kernel library: the threads a CTA aims at,
# and the rays a thread takes where the ray tile allows it (K2 and K4 are
# built for one only). A CTA holds one ray tile as column groups of
# ray_tile / rays_per_thread threads each. At the 128-ray tile: K1 2 groups
# of 64 threads, K2 8 groups of 128; at the 64-ray tile: K3 8 groups of 32
# threads, K4 2 groups of 64 (the fastest shapes of tools/stream_sweep.py
# on the H100, PERF.md section 6).
LAUNCH = {
    "closest_hit": (128, 2),
    "occlusion": (1024, 1),
    "closest_hit_streamed": (256, 2),
    "occlusion_streamed": (128, 1),
}
# The bf16 modes on the tensor cores (K1-K4): the threads a CTA aims at
# and the m-tiles of 16 rays a warp. A CTA holds one ray tile as column
# groups of ray_tile / (16·m_tiles) warps each, at most MMA_MAX_THREADS
# (the kernels' launch bounds: K1 256 at one m-tile a warp, with 3 CTAs an
# SM, K3 and K4 512, K2 1,024; all 1,024 at two, taken where one would need
# more). At the 128-ray tile K1 is 1 group of 8 warps, at the 64-ray tile
# K3 4 groups of 4 (the fastest shapes of tools/stream_sweep.py mma on the
# bounce-1 rays; two m-tiles a warp, held to 64 registers by the
# 1,024-thread bound, was slower; PERF.md section 6). On the NEE shadow
# rays K2 is 4 groups of 8 warps at its 128-ray tile and K4 4 groups of 4
# at its 64-ray tile, as K3 (the fastest shapes there).
LAUNCH_MMA = {
    "closest_hit": (256, 1),
    "occlusion": (1024, 1),
    "closest_hit_streamed": (512, 1),
    "occlusion_streamed": (512, 1),
}
MMA_MAX_THREADS = {
    "closest_hit": {1: 256, 2: 1024},
    "occlusion": {1: 1024, 2: 1024},
    "closest_hit_streamed": {1: 512, 2: 1024},
    "occlusion_streamed": {1: 512, 2: 1024},
}


def mma_route(library: str, precision: str) -> bool:
    """Whether ``library`` runs ``precision`` on the tensor cores: every
    kernel's bf16 modes."""
    return library in LAUNCH_MMA and precision != "highest"


def launch_shape(library: str, ray_tile: int, precision: str = "highest") -> tuple[int, int, int]:
    """``(threads, groups, per)`` of a kernel's CTA for ``ray_tile`` rays (a
    multiple of 32) at ``precision``. On the FMA route ``per`` is the rays
    a thread, and each group is a whole number of warps, so two rays a
    thread need a multiple of 64. On the tensor-core route (``mma_route``)
    ``per`` is the m-tiles of 16 rays a warp, and each group is
    ray_tile / (16·per) warps."""
    if mma_route(library, precision):
        threads, mt = LAUNCH_MMA[library]
        bound = MMA_MAX_THREADS[library]
        if ray_tile // (16 * mt) * 32 > bound[mt]:
            mt = 2
        per_group = ray_tile // (16 * mt) * 32
        groups = max(1, min(threads, bound[mt]) // per_group)
        return per_group * groups, groups, mt
    threads, rpt = LAUNCH[library]
    if ray_tile % (32 * rpt):
        rpt = 1
    per_group = ray_tile // rpt
    groups = max(1, threads // per_group)
    return per_group * groups, groups, rpt


def _shape_ints(library: str, ray_tile: int, precision: str = "highest") -> tuple[int, ...]:
    """The launch shape for ``ray_tile`` as the library's launch and
    occupancy functions take it: ray_tile, groups, ``per``
    (``launch_shape``) and the precision's index in ``PRECISIONS``."""
    _, groups, per = launch_shape(library, ray_tile, precision)
    return ray_tile, groups, per, PRECISIONS.index(precision)


def launch_occupancy(library: str, ray_tile: int, precision: str = "highest", modes: bool = False) -> dict:
    """The launch shape of a kernel's instantiation for ``precision`` (and,
    for K3, its traversal modes), its route ("mma" on the tensor cores,
    else "fma") and its resident CTAs and warps per SM there
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, from the built
    library; needs the CUDA toolkit and a card)."""
    threads, groups, per = launch_shape(library, ray_tile, precision)
    ints = _shape_ints(library, ray_tile, precision) + ((int(modes),) if library == "closest_hit_streamed" else ())
    ctas = getattr(_build.library(library), f"{library}_occupancy")(*ints)
    mma = mma_route(library, precision)
    per_key = "m_tiles_per_warp" if mma else "rays_per_thread"
    if ctas < 0:
        raise RuntimeError(f"{library} does not take ray_tile {ray_tile} as {groups} groups at {per_key} {per} "
                           f"at precision {precision!r}")
    return {"ray_tile": ray_tile, "threads": threads, "groups": groups, per_key: per,
            "route": "mma" if mma else "fma", "precision": precision, "ctas_per_sm": ctas,
            "warps_per_sm": ctas * threads // 32}


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """Duplicated-winding packing + per-block AABBs for the closest-hit kernel."""

    w: torch.Tensor  # (nb, K, NSCALARS*tb) float32, column layout [s0|s1|s2|D|num]
    tri_map: torch.Tensor  # (nb*tb,) int64 — packed row -> scene row
    box_lo: torch.Tensor  # (nb, 3) block AABB
    box_hi: torch.Tensor  # (nb, 3)
    block_live: torch.Tensor  # (nb,) bool — False if every row is padding
    tri_block: int = 512
    # w is exactly zero outside LIVE_SLOTS, as pack_scene leaves it. The
    # kernels read only the live slots, so the searches take only the w of
    # such a pack (marked here; an in-place edit of w unmarks it).
    live_slots_only: bool = False

    def __post_init__(self):
        if self.live_slots_only:
            self.w._live_slots_version = self.w._version

    def to(self, device) -> "PackedScene":
        return to_device(self, device)


def _live_slots_only(w: torch.Tensor) -> bool:
    """Whether ``w`` is the w of a ``live_slots_only`` pack, unedited since."""
    return getattr(w, "_live_slots_version", None) == w._version


def outside_live_slots(w: torch.Tensor) -> torch.Tensor:
    """The values of a packed ``w`` (nb, K, 5·tb) in the slots outside
    ``LIVE_SLOTS``, flat: (K·5 − 25)·nb·tb of them."""
    if w.dim() != 3 or w.shape[1] != K or w.shape[2] % NSCALARS:
        raise ValueError(f"w must be (nb, {K}, {NSCALARS}*tb), got {tuple(w.shape)}")
    live = torch.zeros((K, NSCALARS), dtype=torch.bool, device=w.device)
    for s, k in LIVE_SLOTS:
        live[k, s] = True
    return w.view(w.shape[0], K, NSCALARS, -1).permute(1, 2, 0, 3)[~live].reshape(-1)


def mark_live_slots(packed: PackedScene) -> PackedScene:
    """The pack marked ``live_slots_only``, once its ``w`` is checked to be
    exactly zero outside ``LIVE_SLOTS`` (for a pack that ``pack_scene`` did
    not build, such as the JAX package's carried by ``interop``); raises
    ValueError otherwise. The check reads all of ``w`` once."""
    if bool((outside_live_slots(packed.w) != 0).any()):
        raise ValueError("w is not zero outside LIVE_SLOTS: the kernels would drop its other slots")
    return dataclasses.replace(packed, live_slots_only=True)


# Pack cache: repeated frames pack the same scene tensors; keyed on the five
# tensors the pack reads and tri_block.
_PACK_CACHE = TensorCache(size=4)


def _pack_cache_fields(scene: TriangleScene):
    return (scene.v0, scene.e1, scene.e2, scene.valid, scene.two_sided)


def pack_scene(scene: TriangleScene, tri_block: int = 512) -> PackedScene:
    """Pack a TriangleScene for the one-sided kernel, on the scene's device.

    Valid rows are kept; two-sided rows are appended again with e1 and e2
    swapped (flipped winding), so back-face hits become front-face hits of
    the duplicate. ``tri_map`` sends both copies to the scene row. The pack
    is built from the detached geometry and never requires a gradient: the
    searches are discrete, and ``resolve_hits`` re-derives the hit
    attributes differentiably from the scene.

    Cached on the identity and the version counter of the scene's tensors
    (``core.tensors.TensorCache``). ``torch.optim`` steps a parameter in
    place through the parameter itself, which bumps its version, so the
    next frame repacks; an edit made through ``.data`` bypasses the
    counter, and the cache cannot see it.
    """

    def make():
        v0, e1, e2 = (x.detach() for x in (scene.v0, scene.e1, scene.e2))
        orig = torch.nonzero(scene.valid).flatten()
        flip = torch.nonzero(scene.two_sided & scene.valid).flatten()
        a = torch.cat([v0[orig], v0[flip]])
        b = torch.cat([v0[orig] + e1[orig], v0[flip] + e2[flip]])
        c = torch.cat([v0[orig] + e2[orig], v0[flip] + e1[flip]])
        return _pack_rows(a, b, c, torch.cat([orig, flip]), tri_block)

    return _PACK_CACHE.get(_pack_cache_fields(scene), (tri_block,), make)


def _pack_rows(a2, b2, c2, tri_map, tri_block: int) -> PackedScene:
    dev = a2.device
    m = a2.shape[0]
    # A scene with no live row (a scene shard of padding) packs one dead block.
    pad = (-m) % tri_block if m else tri_block
    live_row = torch.ones((m + pad,), dtype=torch.bool, device=dev)
    if pad:
        z = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
        a2, b2, c2 = torch.cat([a2, z]), torch.cat([b2, z]), torch.cat([c2, z])
        tri_map = torch.cat([tri_map, torch.zeros((pad,), dtype=tri_map.dtype, device=dev)])
        live_row[m:] = False
    m += pad
    nb = m // tri_block

    # Stable spatial (Morton) sort of live rows; dead rows sort to the tail.
    cent = (a2 + b2 + c2) / 3.0
    lf = live_row[:, None]
    lo = torch.where(lf, cent, INF).amin(dim=0)
    hi = torch.where(lf, cent, -INF).amax(dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    codes = torch.where(live_row, morton_codes(cent, lo, hi), 0xFFFFFFFF)
    order = torch.argsort(codes, stable=True)
    a2, b2, c2 = a2[order], b2[order], c2[order]
    tri_map = tri_map[order]
    live_row = live_row[order]
    lf = live_row.to(torch.float32)[:, None]
    a2, b2, c2 = a2 * lf, b2 * lf, c2 * lf  # dead rows stay degenerate

    e1 = b2 - a2
    e2 = c2 - a2
    n_vec = torch.linalg.cross(e1, e2)
    c_plane = (n_vec * a2).sum(dim=-1)
    # cols[s, row, k]: the K-vector whose dot with a ray's features gives
    # scalar s of (ray, row). side = d·(P×Q) + (o×d)·(Q−P); D = N·d;
    # num = c − N·o.
    cols = torch.zeros((NSCALARS, m, K), dtype=torch.float32, device=dev)
    for s, (p, q) in enumerate(((a2, b2), (b2, c2), (c2, a2))):
        cols[s, :, 0:3] = torch.linalg.cross(p, q)
        cols[s, :, 3:6] = q - p
    cols[3, :, 0:3] = n_vec
    cols[4, :, 6:9] = -n_vec
    cols[4, :, 9] = c_plane
    # (5, nb, tb, K) -> (nb, K, 5, tb) -> (nb, K, 5*tb)
    w = cols.view(NSCALARS, nb, tri_block, K).permute(1, 3, 0, 2).reshape(nb, K, NSCALARS * tri_block)

    # Block AABBs over live rows only; all-dead blocks get empty boxes.
    verts = torch.stack([a2, b2, c2], dim=1).reshape(nb, tri_block * 3, 3)
    vlive = live_row.reshape(nb, tri_block).repeat_interleave(3, dim=1)[..., None]
    box_lo = torch.where(vlive, verts, INF).amin(dim=1)
    box_hi = torch.where(vlive, verts, -INF).amax(dim=1)
    block_live = live_row.reshape(nb, tri_block).any(dim=1)
    box_lo = torch.where(block_live[:, None], box_lo, 0.0)
    box_hi = torch.where(block_live[:, None], box_hi, -1.0)
    return PackedScene(
        w=w.contiguous(),
        tri_map=tri_map,
        box_lo=box_lo,
        box_hi=box_hi,
        block_live=block_live,
        tri_block=tri_block,
        live_slots_only=True,
    )


def _interval_div(nlo, nhi, dlo, dhi):
    """Conservative interval [nlo, nhi] / [dlo, dhi]; 0 ∈ d gives (-inf, inf)."""
    safe = lambda x: torch.where(x == 0.0, 1e-30, x)
    c1 = nlo / safe(dlo)
    c2 = nlo / safe(dhi)
    c3 = nhi / safe(dlo)
    c4 = nhi / safe(dhi)
    lo = torch.minimum(torch.minimum(c1, c2), torch.minimum(c3, c4))
    hi = torch.maximum(torch.maximum(c1, c2), torch.maximum(c3, c4))
    straddles = (dlo <= 0.0) & (dhi >= 0.0)
    return torch.where(straddles, -INF, lo), torch.where(straddles, INF, hi)


def tile_block_mask(o, d, packed: PackedScene, ray_tile: int, alive=None):
    """Conservative tile×block culling data, both (ray_tiles, nb):

    - ``mask`` int32: 1 = must test, 0 = no tile ray can hit the block;
    - ``enter`` float32: a lower bound on the hit distance of any tile ray
      into the block's AABB — the larger of the slab interval bound and the
      euclidean box-to-box distance (valid because directions are unit).

    ``alive`` (R,) bool restricts each tile's frustum to its live lanes; an
    all-dead tile culls everything.
    """
    rt = o.shape[0] // ray_tile
    ot = o.reshape(rt, ray_tile, 3)
    dt = d.reshape(rt, ray_tile, 3)
    tile_live = None
    if alive is None:
        o_lo, o_hi = ot.amin(dim=1), ot.amax(dim=1)
        d_lo, d_hi = dt.amin(dim=1), dt.amax(dim=1)
    else:
        at = alive.reshape(rt, ray_tile, 1)
        o_lo = torch.where(at, ot, INF).amin(dim=1)
        o_hi = torch.where(at, ot, -INF).amax(dim=1)
        d_lo = torch.where(at, dt, INF).amin(dim=1)
        d_hi = torch.where(at, dt, -INF).amax(dim=1)
        tile_live = at[:, :, 0].any(dim=1)
        tl = tile_live[:, None]
        o_lo = torch.where(tl, o_lo, 0.0)
        o_hi = torch.where(tl, o_hi, 0.0)
        d_lo = torch.where(tl, d_lo, 1.0)
        d_hi = torch.where(tl, d_hi, 1.0)

    n_lo = packed.box_lo[None, :, :] - o_hi[:, None, :]  # (rt, nb, 3)
    n_hi = packed.box_hi[None, :, :] - o_lo[:, None, :]
    t_lo, t_hi = _interval_div(n_lo, n_hi, d_lo[:, None, :], d_hi[:, None, :])
    enter = torch.clamp(t_lo, min=0.0).amax(dim=-1)
    exit_ = t_hi.amin(dim=-1)
    gap = torch.clamp(torch.maximum(n_lo, -n_hi), min=0.0)
    dist = torch.sqrt((gap * gap).sum(dim=-1))
    enter = torch.maximum(enter, dist)
    hit_possible = (enter <= exit_) & packed.block_live[None, :]
    if tile_live is not None:
        hit_possible &= tile_live[:, None]
    return hit_possible.to(torch.int32), enter


def plan_block_order(mask: torch.Tensor, enter: torch.Tensor):
    """Per-tile front-to-back block schedule ``(order, enter_sorted)``, both
    (ray_tiles, nb): blocks by ascending entry bound (stable), culled blocks
    at the tail with id ``nb`` and enter = +inf."""
    nb = mask.shape[1]
    key = torch.where(mask > 0, enter, INF)
    order = torch.argsort(key, dim=1, stable=True)
    enter_sorted = torch.gather(key, 1, order)
    order = torch.where(torch.isfinite(enter_sorted), order, nb)
    return order.to(torch.int32), enter_sorted


class Route(NamedTuple):
    """A pack's route (``route``)."""

    streamed: bool
    bpc: int  # blocks a cluster of the streamed route
    ray_tile: int


def route(blocks: int, tri_block: int, ray_tile: int = DEFAULT_RAY_TILE) -> Route:
    """The route of a pack of ``blocks`` blocks of ``tri_block`` rows, by
    the JAX package's rule, with ``RESIDENT_BUDGET_BYTES`` and
    ``CLUSTER_TARGET_BYTES`` read at call time: a pack of more than
    ``RESIDENT_BUDGET_BYTES`` is streamed, in tiles of ``STREAM_RAY_TILE``
    rays unless ``ray_tile`` is not the default. ``bpc`` is the blocks of
    about ``CLUSTER_TARGET_BYTES`` that a cluster of the streamed route
    holds (at least 1, at most ``blocks``), given on either route."""
    block_bytes = K * NSCALARS * tri_block * 4
    streamed = blocks * block_bytes > RESIDENT_BUDGET_BYTES
    bpc = min(max(1, CLUSTER_TARGET_BYTES // block_bytes), max(blocks, 1))
    return Route(streamed, bpc, STREAM_RAY_TILE if streamed and ray_tile == DEFAULT_RAY_TILE else ray_tile)


def _pad_blocks(packed: PackedScene, bpc: int) -> PackedScene:
    """The pack with its block axis padded to a multiple of ``bpc`` by dead
    blocks: zero columns, box lo 0 and hi -1, ``block_live`` False.
    ``tri_map`` is not padded (no hit lands in a dead block). Zero columns
    keep ``live_slots_only``. Cached on ``w`` (as the live-slot mark is),
    keyed on ``bpc``, the pack's fields, its other tensors and every
    tensor's version counter, so that every streamed search of a pack
    reuses one padded pack and the precision operands that
    ``_kernel_operands`` caches on its ``w``, and the copy is freed with
    ``w``; an in-place edit of any of the pack's tensors makes it anew. A
    ``w`` that requires grad is padded anew each time."""
    w = packed.w
    pad = (-w.shape[0]) % bpc
    if pad == 0:
        return packed
    others = (packed.tri_map, packed.box_lo, packed.box_hi, packed.block_live)
    key = (bpc, packed.tri_block, packed.live_slots_only, w._version) + tuple(x._version for x in others)
    cached = getattr(w, "_padded", None)
    if cached is not None and cached[0] == key and all(x is y for x, y in zip(cached[1], others)):
        return cached[2]
    padded = dataclasses.replace(
        packed,
        w=torch.cat([w, w.new_zeros((pad,) + tuple(w.shape[1:]))]),
        box_lo=torch.cat([packed.box_lo, packed.box_lo.new_zeros((pad, 3))]),
        box_hi=torch.cat([packed.box_hi, packed.box_hi.new_full((pad, 3), -1.0)]),
        block_live=torch.cat([packed.block_live, packed.block_live.new_zeros((pad,))]),
    )
    if not w.requires_grad:
        w._padded = (key, others, padded)
    return padded


def cluster_schedule(mask: torch.Tensor, enter: torch.Tensor, bpc: int):
    """The streamed route's schedule from the block-level cull data (both
    (ray_tiles, nb), nb a multiple of ``bpc``): ``(order, enter_sorted,
    enter_blk)``. A cluster is scheduled iff one of its blocks survives, keyed
    by the least entry bound among them; ``order``/``enter_sorted`` are
    (ray_tiles, nb // bpc) as ``plan_block_order`` gives them (culled
    clusters at the tail, id nb // bpc, +inf), and ``enter_blk`` (ray_tiles,
    nb) is each block's entry bound, +inf where culled."""
    rt = mask.shape[0]
    enter_blk = torch.where(mask > 0, enter, INF)
    cmask = mask.reshape(rt, -1, bpc).amax(dim=-1)
    ckey = enter_blk.reshape(rt, -1, bpc).amin(dim=-1)
    order, enter_sorted = plan_block_order(cmask, ckey)
    return order, enter_sorted, enter_blk


def _check_inputs(spec: _Search, schedule, feats, lanes, w, ray_tile: int, tests) -> None:
    """Raise on anything the kernel of ``spec`` does not take. ``schedule``
    is ``(order, enter)``, or for the streamed searches ``(order, enter,
    enter_blk)`` with one column per cluster of ``nb // order.shape[1]``
    blocks; ``lanes`` is the per-ray input after ``feats`` (``spec.lanes``:
    ``alive`` int32 for the closest hit, ``maxt`` float32 for the any hit);
    ``tests`` is None or int64 (1,). ``w`` must be a
    ``live_slots_only`` pack's, on every device (a host-side check: nothing
    synchronises)."""
    if w.dim() != 3 or w.shape[1] != K or w.shape[2] % NSCALARS:
        raise ValueError(f"w must be (nb, {K}, {NSCALARS}*tb), got {tuple(w.shape)}")
    nb, tb = w.shape[0], w.shape[2] // NSCALARS
    if feats.dim() != 2 or feats.shape[1] != K or feats.shape[0] % ray_tile:
        raise ValueError(f"feats must be (rt*{ray_tile}, {K}), got {tuple(feats.shape)}")
    rt = feats.shape[0] // ray_tile
    order, enter, *enter_blk = schedule
    nsched = nb
    if enter_blk:
        nsched = order.shape[1] if order.dim() == 2 else 0
        if nsched == 0 or nb % nsched:
            raise ValueError(f"order must have one column per cluster of the {nb} blocks, got {tuple(order.shape)}")
    if not _live_slots_only(w):
        raise ValueError("the packed searches read only LIVE_SLOTS of w: w must be the w of a live_slots_only "
                         "pack (pack_scene's, padded or moved, or one marked by mark_live_slots), unedited since")
    lanes_name, lanes_dtype = spec.lanes
    expect = [("order", order, torch.int32, (rt, nsched)), ("enter", enter, torch.float32, (rt, nsched)),
              *(("enter_blk", x, torch.float32, (rt, nb)) for x in enter_blk),
              ("feats", feats, torch.float32, (rt * ray_tile, K)), (lanes_name, lanes, lanes_dtype, (rt * ray_tile,)),
              ("w", w, torch.float32, (nb, K, NSCALARS * tb))]
    if tests is not None:
        expect.append(("tests", tests, torch.int64, (1,)))
    for what, x, dtype, shape in expect:
        # The kernels copy w and its bf16 operands (_kernel_operands' fresh
        # allocations) in 16-byte pieces.
        _build.check(spec.library, x, what, dtype, shape, feats.device, aligned=x is w)
    if rt == 0 or nb == 0:
        raise ValueError("the packed search needs at least one ray tile and one block")
    if ray_tile % 32 or not 32 <= ray_tile <= 1024:
        raise ValueError(f"ray_tile must be a multiple of 32 in [32, 1024], got {ray_tile}")
    if tb % 4:
        raise ValueError(f"tri_block must be a multiple of 4, got {tb}")


def _kernel_device(feats, name: str) -> torch.device | None:
    """None for CPU tensors (the plain version runs), the CUDA device
    otherwise; raises for any other device."""
    dev = feats.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {dev.type}")
    return dev


# Pairs (ray x column) the plain versions evaluate per batched matmul; bounds
# their (tiles, ray_tile, 5*tb) intermediates to ~128 MB each.
_REFERENCE_PAIRS = 1 << 25


def _check_f32_matmul(feats, name: str) -> None:
    if feats.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{name} needs f32 matmuls: TF32 is enabled")


def _decision_scalars(ft, w, blk, tb: int, precision: str = "highest"):
    """(s0, s1, s2, D, num), each (tiles, ray_tile, tb): each tile's features
    times its scheduled block at ``precision``, as the JAX package's
    ``_decision_dot``: f32 matmuls, of the bf16 splits (``split_bf16``) for
    the bf16 modes. Every matmul is the full (ray_tile, 5·tb) product, so
    that each sum runs as the "highest" one does."""
    wb = w[blk]
    if precision == "highest":
        s = torch.bmm(ft, wb)
    else:
        (fh, fl), (wh, wl) = split_bf16(ft), split_bf16(wb)
        s = torch.bmm(fh, wh)
        if precision != "default":
            s = s + (torch.bmm(fh, wl) + torch.bmm(fl, wh))
        if precision == "mixed":
            s = torch.cat([s[..., : 3 * tb], torch.bmm(ft, wb)[..., 3 * tb :]], dim=-1)
    return s.view(ft.shape[0], ft.shape[1], NSCALARS, tb).unbind(2)


def _block_min(ft, w, blk, tb: int, precision: str = "highest"):
    """Per lane of each (tile, block) pair, the least accepted t (BIG if
    none) and its packed row; ties go to the lower column."""
    s0, s1, s2, dd, num = _decision_scalars(ft, w, blk, tb, precision)
    edge = torch.maximum(torch.maximum(s0, s1), s2)
    ok = (edge <= 0.0) & (dd <= -EPSILON) & (num < EPSILON * dd)
    t = torch.where(ok, num / dd, BIG)
    blk_min, blk_arg = t.min(dim=-1)  # first index wins ties
    return blk_min, (blk_arg + blk[:, None] * tb).to(torch.int32)


def _blocked(ft, mt, w, blk, tb: int, precision: str = "highest"):
    """Per lane of each (tile, block) pair: some accepted hit with t in
    (EPSILON, mt). t = num / D lies there iff num < EPSILON·D and
    num > mt·D, both strict (D <= -EPSILON < 0 flips them)."""
    s0, s1, s2, dd, num = _decision_scalars(ft, w, blk, tb, precision)
    edge = torch.maximum(torch.maximum(s0, s1), s2)
    ok = (edge <= 0.0) & (dd <= -EPSILON) & (num < EPSILON * dd) & (num > mt[:, :, None] * dd)
    return ok.any(dim=-1)


def closest_hit_reference(
    order, enter, feats, alive, w, ray_tile: int = DEFAULT_RAY_TILE, count_work: bool = False,
    precision: str = "highest", tests=None,
):
    """Plain PyTorch version of ``closest_hit``: the same schedule, early exit,
    acceptance and tie-breaks, with one matmul per (tile, block) at
    ``precision`` (three for "high" and "mixed").

    ``count_work=True`` also returns ``{"blocks": visited (tile, block)
    pairs, "lane_blocks": the sum over them of the tile's live lanes}``,
    the work these inputs need; ``tests`` takes ``lane_blocks`` x tb."""
    _check_f32_matmul(feats, "closest_hit_reference")
    precision = resolve_precision(precision)
    nb, _, five_tb = w.shape
    tb = five_tb // NSCALARS
    rt = feats.shape[0] // ray_tile
    ft = feats.reshape(rt, ray_tile, K)
    live = alive.reshape(rt, ray_tile) > 0
    best_t = torch.where(live, BIG, -INF).to(torch.float32)
    best_i = torch.full((rt, ray_tile), -1, dtype=torch.int32, device=feats.device)
    worst = torch.full((rt,), INF, dtype=torch.float32, device=feats.device)
    running = torch.ones((rt,), dtype=torch.bool, device=feats.device)
    per_call = max(1, _REFERENCE_PAIRS // (ray_tile * five_tb))
    blocks = lane_blocks = 0
    for j in range(nb):
        running &= enter[:, j] < worst
        tiles = torch.nonzero(running).flatten()
        if tiles.numel() == 0:
            break
        if count_work or tests is not None:
            blocks += tiles.numel()
            lane_blocks += int(live[tiles].sum())
        for c0 in range(0, tiles.numel(), per_call):
            ti = tiles[c0 : c0 + per_call]
            blk_min, arg = _block_min(ft[ti], w, order[ti, j].long(), tb, precision)
            bt = best_t[ti]
            upd = blk_min < bt  # strict <: earlier blocks win ties
            best_t[ti] = torch.where(upd, blk_min, bt)
            best_i[ti] = torch.where(upd & (blk_min < BIG), arg, best_i[ti])
        worst[tiles] = best_t[tiles].amax(dim=1)
    if tests is not None:
        tests += lane_blocks * tb
    out = (best_t.reshape(-1), best_i.reshape(-1))
    return out + ({"blocks": blocks, "lane_blocks": lane_blocks},) if count_work else out


def _check_stream_modes(feats, ray_tile: int, init_t, init_i, budget, subtiles: int) -> None:
    """Raise on traversal modes the streamed closest hit does not take."""
    if (init_t is None) != (init_i is None):
        raise ValueError("init_t and init_i seed the lanes together: give both or neither")
    if init_t is not None:
        for what, x, dtype in (("init_t", init_t, torch.float32), ("init_i", init_i, torch.int32)):
            _build.check("closest_hit_streamed", x, what, dtype, (feats.shape[0],), feats.device)
    if budget is not None and budget < 1:
        raise ValueError(f"budget must be None or at least 1, got {budget}")
    if subtiles < 1 or ray_tile % subtiles:
        raise ValueError(f"subtiles must divide ray_tile {ray_tile}, got {subtiles}")


def closest_hit_streamed_reference(
    order, enter, enter_blk, feats, alive, w, ray_tile: int = STREAM_RAY_TILE, count_work: bool = False,
    precision: str = "highest", init_t=None, init_i=None, budget: int | None = None, subtiles: int = 1,
    fresh: bool = False, with_done: bool = False, tests=None,
):
    """Plain PyTorch version of ``closest_hit_streamed``, as the TPU kernel
    ``_kernel_streamed`` runs: live lanes start at ``init_t`` (BIG by
    default), dead lanes at -inf, best_i at ``init_i`` (-1), and the tile's
    worst lane is their max. Clusters go in schedule order while fewer than
    ``budget`` were visited and their entry bound is below the worst; inside
    a cluster the blocks ascend, and block b is computed for a lane iff its
    own entry bound is below the lane's gate: the worst at the cluster's
    start; with ``fresh``, the tile's running worst; with ``subtiles`` > 1,
    the running worst of the lane's group of ray_tile / subtiles lanes.
    ``closest_hit``'s acceptance and tie rules; after each cluster the worst
    is the tile's max best_t again. ``done`` (``with_done``) is 1 where the
    schedule ran out (the loop stopped at j >= nc) or best_t is at most the
    entry bound of the cluster the loop stopped at.

    ``count_work=True`` also returns ``{"blocks": computed (tile, block)
    pairs, "lane_blocks": the sum over them of the live lanes they were
    computed for}``, after ``done``; ``tests`` takes ``lane_blocks`` x tb."""
    _check_f32_matmul(feats, "closest_hit_streamed_reference")
    precision = resolve_precision(precision)
    _check_stream_modes(feats, ray_tile, init_t, init_i, budget, subtiles)
    nb, _, five_tb = w.shape
    tb = five_tb // NSCALARS
    nc = order.shape[1]
    bpc = nb // nc
    rt = feats.shape[0] // ray_tile
    dev = feats.device
    ft = feats.reshape(rt, ray_tile, K)
    live = alive.reshape(rt, ray_tile) > 0
    seed_t = BIG if init_t is None else init_t.reshape(rt, ray_tile)
    best_t = torch.where(live, seed_t, -INF).to(torch.float32)
    best_i = (torch.full((rt, ray_tile), -1, dtype=torch.int32, device=dev) if init_i is None
              else init_i.reshape(rt, ray_tile).clone())
    worst = best_t.amax(dim=1)
    cap = nc if budget is None else min(budget, nc)
    j_end = torch.full((rt,), cap, dtype=torch.int64, device=dev)
    running = torch.ones((rt,), dtype=torch.bool, device=dev)
    per_call = max(1, _REFERENCE_PAIRS // (ray_tile * five_tb))
    gated = fresh or subtiles > 1
    counting = count_work or tests is not None
    blocks = lane_blocks = 0
    for j in range(cap):
        go = running & (enter[:, j] < worst)
        j_end[running & ~go] = j
        running = go
        tiles = torch.nonzero(running).flatten()
        if tiles.numel() == 0:
            break
        blk = order[tiles, j].long()[:, None] * bpc + torch.arange(bpc, device=dev)  # (n, bpc)
        if gated:
            for b in range(bpc):
                bt = best_t[tiles]
                gate = (bt.view(-1, subtiles, ray_tile // subtiles).amax(dim=-1) if subtiles > 1
                        else bt.amax(dim=1, keepdim=True))
                on = (enter_blk[tiles, blk[:, b]][:, None] < gate).repeat_interleave(ray_tile // gate.shape[1], dim=1)
                sel = torch.nonzero(on.any(dim=1)).flatten()
                if counting:
                    blocks += sel.numel()
                    lane_blocks += int((live[tiles] & on).sum())
                for c0 in range(0, sel.numel(), per_call):
                    qs = sel[c0 : c0 + per_call]
                    ti = tiles[qs]
                    m, a = _block_min(ft[ti], w, blk[qs, b], tb, precision)
                    upd = on[qs] & (m < best_t[ti])  # strict <: earlier blocks win ties
                    best_t[ti] = torch.where(upd, m, best_t[ti])
                    best_i[ti] = torch.where(upd & (m < BIG), a, best_i[ti])
        else:
            # Every block of a cluster is tested against the cluster-start
            # worst, so the cluster's blocks are evaluated together and folded
            # in block order: min over blocks with the first block winning
            # ties is the chain of strict-< updates block by block.
            pt, pb = torch.nonzero(enter_blk[tiles[:, None], blk] < worst[tiles][:, None], as_tuple=True)
            if counting:
                blocks += pt.numel()
                lane_blocks += int(live[tiles[pt]].sum())
            m = torch.full((tiles.numel(), bpc, ray_tile), BIG, dtype=torch.float32, device=dev)
            a = torch.zeros((tiles.numel(), bpc, ray_tile), dtype=torch.int32, device=dev)
            for c0 in range(0, pt.numel(), per_call):
                qt, qb = pt[c0 : c0 + per_call], pb[c0 : c0 + per_call]
                m[qt, qb], a[qt, qb] = _block_min(ft[tiles[qt]], w, blk[qt, qb], tb, precision)
            cmin, cb = m.min(dim=1)  # first block wins ties
            carg = torch.gather(a, 1, cb[:, None]).squeeze(1)
            # A cluster with no computed block leaves every lane as it was.
            computed = torch.zeros((tiles.numel(),), dtype=torch.bool, device=dev)
            computed[pt] = True
            bt = best_t[tiles]
            upd = computed[:, None] & (cmin < bt)  # strict <: earlier clusters win ties
            best_t[tiles] = torch.where(upd, cmin, bt)
            best_i[tiles] = torch.where(upd & (cmin < BIG), carg, best_i[tiles])
        worst[tiles] = best_t[tiles].amax(dim=1)
    if tests is not None:
        tests += lane_blocks * tb
    out = (best_t.reshape(-1), best_i.reshape(-1))
    if with_done:
        next_enter = torch.gather(enter, 1, j_end.clamp(max=nc - 1)[:, None])
        out += (((j_end[:, None] >= nc) | (best_t <= next_enter)).to(torch.int32).reshape(-1),)
    return out + ({"blocks": blocks, "lane_blocks": lane_blocks},) if count_work else out


def occluded_reference(
    order, enter, feats, maxt, w, ray_tile: int = DEFAULT_RAY_TILE, count_work: bool = False,
    precision: str = "highest",
):
    """Plain PyTorch version of ``occluded``: the same schedule and per-tile
    bound (the largest cutoff among unoccluded lanes; every lane occluded
    gives -inf), and the same division-free acceptance, with one matmul per
    (tile, block) at ``precision`` (three for "high" and "mixed").

    ``count_work=True`` also returns ``{"blocks": visited (tile, block)
    pairs, "lane_blocks": the sum over them of the tile's lanes that still
    need testing (unoccluded, maxt > 0)}``."""
    _check_f32_matmul(feats, "occluded_reference")
    precision = resolve_precision(precision)
    nb, _, five_tb = w.shape
    tb = five_tb // NSCALARS
    rt = feats.shape[0] // ray_tile
    ft = feats.reshape(rt, ray_tile, K)
    mt = maxt.reshape(rt, ray_tile)
    occ = torch.zeros((rt, ray_tile), dtype=torch.bool, device=feats.device)
    running = torch.ones((rt,), dtype=torch.bool, device=feats.device)
    per_call = max(1, _REFERENCE_PAIRS // (ray_tile * five_tb))
    blocks = lane_blocks = 0
    for j in range(nb):
        bound = torch.where(occ, -INF, mt).amax(dim=1)
        running &= enter[:, j] < bound
        tiles = torch.nonzero(running).flatten()
        if tiles.numel() == 0:
            break
        if count_work:
            blocks += tiles.numel()
            lane_blocks += int((~occ[tiles] & (mt[tiles] > 0)).sum())
        for c0 in range(0, tiles.numel(), per_call):
            ti = tiles[c0 : c0 + per_call]
            occ[ti] |= _blocked(ft[ti], mt[ti], w, order[ti, j].long(), tb, precision)
    out = occ.reshape(-1).to(torch.int32)
    return (out, {"blocks": blocks, "lane_blocks": lane_blocks}) if count_work else out


def occluded_streamed_reference(
    order, enter, enter_blk, feats, maxt, w, ray_tile: int = STREAM_RAY_TILE, count_work: bool = False,
    precision: str = "highest", tests=None,
):
    """Plain PyTorch version of ``occluded_streamed``, as the TPU kernel
    ``_kernel_occlusion_streamed`` runs: flags start at 0 and the tile's
    bound at +inf, so the first scheduled cluster is always visited. Clusters
    go in schedule order while their entry bound is below the bound; inside
    a cluster a block is tested iff its own entry bound is below the bound
    at the cluster's start, blocks ascending, with ``occluded``'s
    acceptance at ``precision``. After each cluster the bound is the largest
    cutoff among unoccluded lanes (-inf once all are occluded).

    ``count_work=True`` also returns ``{"blocks": tested (tile, block)
    pairs, "lane_blocks": the sum over them of the tile's lanes that still
    need testing (unoccluded, maxt > 0)}``; ``tests`` takes ``lane_blocks``
    x tb."""
    _check_f32_matmul(feats, "occluded_streamed_reference")
    precision = resolve_precision(precision)
    nb, _, five_tb = w.shape
    tb = five_tb // NSCALARS
    nc = order.shape[1]
    bpc = nb // nc
    rt = feats.shape[0] // ray_tile
    dev = feats.device
    ft = feats.reshape(rt, ray_tile, K)
    mt = maxt.reshape(rt, ray_tile)
    occ = torch.zeros((rt, ray_tile), dtype=torch.bool, device=dev)
    bound = torch.full((rt,), INF, dtype=torch.float32, device=dev)
    running = torch.ones((rt,), dtype=torch.bool, device=dev)
    per_call = max(1, _REFERENCE_PAIRS // (ray_tile * five_tb))
    counting = count_work or tests is not None
    blocks = lane_blocks = 0
    for j in range(nc):
        running &= enter[:, j] < bound
        tiles = torch.nonzero(running).flatten()
        if tiles.numel() == 0:
            break
        first = order[tiles, j].long() * bpc
        start = bound[tiles]
        # Block by block: a lane occluded in one block is not tested in the
        # next, which the work count follows.
        for b in range(bpc):
            go = enter_blk[tiles, first + b] < start
            ti, blk = tiles[go], first[go] + b
            if counting:
                blocks += ti.numel()
                lane_blocks += int((~occ[ti] & (mt[ti] > 0)).sum())
            for c0 in range(0, ti.numel(), per_call):
                tc = ti[c0 : c0 + per_call]
                occ[tc] |= _blocked(ft[tc], mt[tc], w, blk[c0 : c0 + per_call], tb, precision)
        bound[tiles] = torch.where(occ[tiles], -INF, mt[tiles]).amax(dim=1)
    if tests is not None:
        tests += lane_blocks * tb
    out = occ.reshape(-1).to(torch.int32)
    return (out, {"blocks": blocks, "lane_blocks": lane_blocks}) if count_work else out


@dataclasses.dataclass(frozen=True)
class _Search:
    """What sets one of the four packed searches apart: its kernel library,
    the name and dtype of its per-ray input, the dtypes of its (R_pad,)
    outputs, whether it takes the test counter, whether it takes K3's
    traversal modes (and then may return ``done``), and the name of its
    plain version, which is looked up in this module when it is called, so
    that a caller may patch it."""

    library: str
    lanes: tuple
    outputs: tuple
    counts: bool
    modes: bool
    plain: str


_CLOSEST_HIT = _Search("closest_hit", ("alive", torch.int32), (torch.float32, torch.int32), True, False,
                       "closest_hit_reference")
_CLOSEST_HIT_STREAMED = _Search("closest_hit_streamed", ("alive", torch.int32), (torch.float32, torch.int32), True,
                                True, "closest_hit_streamed_reference")
_OCCLUDED = _Search("occlusion", ("maxt", torch.float32), (torch.int32,), False, False, "occluded_reference")
_OCCLUDED_STREAMED = _Search("occlusion_streamed", ("maxt", torch.float32), (torch.int32,), True, False,
                             "occluded_streamed_reference")


def _search(spec: _Search, schedule: tuple, feats, lanes, w, ray_tile: int, precision: str, tests=None,
            init_t=None, init_i=None, budget: int | None = None, subtiles: int = 1, fresh: bool = False,
            with_done: bool = False):
    """The body of the four searches: check the inputs, then run the plain
    version on CPU tensors, or launch the kernel of ``spec`` on CUDA
    tensors, on ``schedule`` (``(order, enter)``, or ``(order, enter,
    enter_blk)`` streamed). The traversal modes are K3's."""
    precision = resolve_precision(precision)
    _check_inputs(spec, schedule, feats, lanes, w, ray_tile, tests)
    counter = {"tests": tests} if spec.counts else {}
    modes = {}
    if spec.modes:
        _check_stream_modes(feats, ray_tile, init_t, init_i, budget, subtiles)
        modes = dict(init_t=init_t, init_i=init_i, budget=budget, subtiles=subtiles, fresh=fresh, with_done=with_done)
    dev = _kernel_device(feats, spec.library)
    if dev is None:
        return globals()[spec.plain](*schedule, feats, lanes, w, ray_tile, precision=precision, **modes, **counter)
    out = [torch.empty(feats.shape[0], dtype=dtype, device=dev) for dtype in spec.outputs]
    any_mode = init_t is not None or budget is not None or subtiles > 1 or fresh or with_done
    seeds, mode_ints = (), ()
    if spec.modes:
        out.append(torch.empty(feats.shape[0], dtype=torch.int32, device=dev) if any_mode else None)  # done
        seeds, mode_ints = (init_t, init_i), (int(any_mode), budget or 0, subtiles, int(fresh))
    rt, nb, nsched = feats.shape[0] // ray_tile, w.shape[0], schedule[0].shape[1]
    shape = (rt, nb) if len(schedule) == 2 else (rt, nsched, nb // nsched)
    _build.launch(spec.library, f"{spec.library}_launch", dev, *schedule, feats, lanes, *seeds,
                  *_kernel_operands(w, precision), *out, *counter.values(), *shape, w.shape[2] // NSCALARS,
                  *_shape_ints(spec.library, ray_tile, precision), *mode_ints)
    if spec.modes and not with_done:
        out.pop()
    return out[0] if len(out) == 1 else tuple(out)


def closest_hit(order, enter, feats, alive, w, ray_tile: int = DEFAULT_RAY_TILE, precision: str = "highest",
                tests=None):
    """Closest hit of every ray tile along its schedule: ``(best_t, best_i)``,
    (R_pad,) float32 and int32 (packed row, -1 on miss; dead lanes -inf/-1),
    with the decision product at ``precision`` (``PRECISIONS``). ``tests``
    (int64 (1,) on the rays' device, or None) takes the (live lane, triangle
    column) tests computed: the blocks each tile computed x its live lanes
    x tb, the plain version's ``lane_blocks`` x tb.

    On CUDA tensors this launches the hand-written kernel
    (``csrc/closest_hit.cu``, at ``launch_shape``) and raises if it cannot;
    on CPU tensors it runs ``closest_hit_reference``. The kernel reads only
    the ``LIVE_SLOTS`` of ``w``, so ``w`` must be the w of a
    ``live_slots_only`` pack (``pack_scene``'s, or one marked by
    ``mark_live_slots``); any other raises, on every device.
    """
    return _search(_CLOSEST_HIT, (order, enter), feats, alive, w, ray_tile, precision, tests)


def closest_hit_streamed(
    order, enter, enter_blk, feats, alive, w, ray_tile: int = STREAM_RAY_TILE, precision: str = "highest",
    init_t=None, init_i=None, budget: int | None = None, subtiles: int = 1, fresh: bool = False,
    with_done: bool = False, tests=None,
):
    """Closest hit of every ray tile along its cluster schedule (the streamed
    route): ``(best_t, best_i)`` as ``closest_hit`` gives them, and the
    tests computed added to ``tests`` as there. ``order`` and
    ``enter`` are (rt, nc), ``enter_blk`` (rt, nb) and ``w`` (nb, K, 5·tb)
    with nb a multiple of nc (``cluster_schedule``, ``_pad_blocks``).

    The traversal modes of the JAX package's ``_kernel_streamed``: live
    lanes start from ``init_t``/``init_i`` (both or neither; BIG and -1 by
    default), dead lanes from -inf and ``init_i``; a tile visits at most
    ``budget`` clusters; ``subtiles`` > 1 gates each block on the running
    worst of each group of ray_tile / subtiles lanes, ``fresh`` on the
    tile's running worst. ``with_done=True`` also returns ``done``, int32
    (R_pad,): 1 where the lane's result is final (the schedule ran out, or
    its best_t is at most the entry bound of the next unvisited cluster).

    On CUDA tensors this launches the hand-written kernel
    (``csrc/closest_hit_streamed.cu``, at ``launch_shape``; the mode
    instantiation when any mode is asked for) and raises if it cannot; on
    CPU tensors it runs ``closest_hit_streamed_reference``. The kernel reads
    only the ``LIVE_SLOTS`` of ``w``, so ``w`` must be the w of a
    ``live_slots_only`` pack (``pack_scene``'s, padded by ``_pad_blocks``
    or moved by ``to``); any other raises, on every device.
    """
    return _search(_CLOSEST_HIT_STREAMED, (order, enter, enter_blk), feats, alive, w, ray_tile, precision, tests,
                   init_t, init_i, budget, subtiles, fresh, with_done)


def occluded(order, enter, feats, maxt, w, ray_tile: int = DEFAULT_RAY_TILE, precision: str = "highest"):
    """Any-hit search of every ray tile along its schedule: an int32 flag
    (R_pad,), 1 where some accepted hit has t < ``maxt`` (lanes with
    ``maxt = 0`` are never tested and report 0), with the decision product
    at ``precision``.

    On CUDA tensors this launches the hand-written kernel
    (``csrc/occlusion.cu``, at ``launch_shape``) and raises if it cannot; on
    CPU tensors it runs ``occluded_reference``. The kernel reads only the
    ``LIVE_SLOTS`` of ``w``, as ``closest_hit``.
    """
    return _search(_OCCLUDED, (order, enter), feats, maxt, w, ray_tile, precision)


def occluded_streamed(order, enter, enter_blk, feats, maxt, w, ray_tile: int = STREAM_RAY_TILE,
                      precision: str = "highest", tests=None):
    """Any-hit search of every ray tile along its cluster schedule (the
    streamed route): int32 flags as ``occluded`` gives them, with the
    schedule inputs of ``closest_hit_streamed`` and the decision product at
    ``precision``. ``tests`` (int64 (1,) on the rays' device, or None)
    takes the (open lane, triangle column) tests of the blocks tested: for
    each tested (tile, block), the tile's lanes still open at its start
    (unoccluded, maxt > 0) x tb, the plain version's ``lane_blocks`` x tb.

    On CUDA tensors this launches the hand-written kernel
    (``csrc/occlusion_streamed.cu``, at ``launch_shape``) and raises
    if it cannot; on CPU tensors it runs ``occluded_streamed_reference``.
    The kernel reads only the ``LIVE_SLOTS`` of ``w``, as
    ``closest_hit_streamed``.
    """
    return _search(_OCCLUDED_STREAMED, (order, enter, enter_blk), feats, maxt, w, ray_tile, precision, tests)


def schedule_route(device: torch.device, plain: bool = False) -> str:
    """The route of a search's schedule (``SCHEDULE_ROUTES``): "kernel" (one
    launch of csrc/schedule.cu, which takes float32 rays) for rays on a CUDA
    ``device``; "ops" (the torch ops, the plain version that the CPU tests
    hold to the JAX package) on the CPU, and with ``plain``, where the
    search too runs its plain version."""
    return "kernel" if device.type == "cuda" and not plain else "ops"


def _tile_schedule(o, d, live, packed: PackedScene, way: Route, how: str):
    """The schedule of rays already padded to whole tiles (``packed`` padded
    to whole clusters on the streamed route) with live lanes ``live`` (bool,
    None: all): ``(order, enter_sorted)``, or ``(order, enter_sorted,
    enter_blk)`` streamed, by the route ``how``."""
    if how == "kernel":
        out = schedule.tile_schedule(o, d, live, packed, way.bpc if way.streamed else 0, way.ray_tile, rays=False)
        return out[:3] if way.streamed else out[:2]
    mask, enter = tile_block_mask(o, d, packed, way.ray_tile, alive=live)
    return cluster_schedule(mask, enter, way.bpc) if way.streamed else plan_block_order(mask, enter)


def prepare(o, d, lanes, packed: PackedScene, way: Route, any_hit: bool = False, plain: bool = False):
    """A search's inputs for rays (R, 3) with unit directions on the route
    ``way``: ``(o, d, packed, inputs)``, with the rays padded to a multiple
    of ``way.ray_tile`` and, on the streamed route, the pack's blocks padded
    to whole clusters of ``way.bpc``; ``inputs`` are the search's leading
    arguments, ``(order, enter, feats, lanes, w)`` on the resident route and
    ``(order, enter, enter_blk, feats, lanes, w)`` on the streamed one.
    ``lanes`` is the closest hit's live mask (R,) bool (None: every lane is
    live; int32 in ``inputs``), or with ``any_hit`` the cutoffs ``max_t``
    (R,) (float32 in ``inputs``). The tile frustums follow the live lanes,
    or the lanes with ``max_t`` > 0. Padded lanes carry o = 0, d = (1, 1, 1)
    and lane value 0: dead, or never tested.

    Runs in a ``render.schedule`` span whose input is the route
    (``schedule_route`` of the device and ``plain``, ``SCHEDULE_ROUTES``):
    on the kernel route one launch makes every input but ``w``, the same to
    the bit."""
    how = schedule_route(o.device, plain)
    with scope("render.schedule", SCHEDULE_ROUTES.index(how)):
        if way.streamed:
            packed = _pad_blocks(packed, way.bpc)
        if how == "kernel":
            dtypes = (torch.float32,) if any_hit else (torch.bool, torch.int32)
            if lanes is not None and lanes.dtype not in dtypes:
                lanes = lanes.to(dtypes[-1])
            order, enter, enter_blk, feats, lanes, o_pad, d_pad = schedule.tile_schedule(
                o, d, lanes, packed, way.bpc if way.streamed else 0, way.ray_tile, any_hit)
            if o_pad.shape[0]:
                o, d = o_pad, d_pad
            sched = (order, enter, enter_blk) if way.streamed else (order, enter)
            return o, d, packed, (*sched, feats, lanes, packed.w)
        everyone = lanes is None and not any_hit
        if any_hit:
            lanes = lanes.to(torch.float32)
        elif everyone:
            lanes = torch.ones((o.shape[0],), dtype=torch.int32, device=o.device)
        else:
            lanes = lanes.to(torch.int32)
        feats = pack_rays(o, d)
        pad = (-o.shape[0]) % way.ray_tile
        if pad:
            feats = torch.cat([feats, feats.new_zeros((pad, K))])
            o = torch.cat([o, o.new_zeros((pad, 3))])
            d = torch.cat([d, d.new_ones((pad, 3))])
            lanes = torch.cat([lanes, lanes.new_zeros((pad,))])
        lanes = lanes.contiguous()
        sched = _tile_schedule(o, d, None if everyone and not pad else lanes > 0, packed, way, how)
        return o, d, packed, (*sched, feats, lanes, packed.w)


def _streamed(packed: PackedScene, ray_tile: int) -> Route:
    """The streamed route of ``packed`` at ``ray_tile``, whatever its size."""
    return Route(True, route(packed.w.shape[0], packed.tri_block).bpc, ray_tile)


def prepare_rays(o, d, packed: PackedScene, alive=None, ray_tile: int = DEFAULT_RAY_TILE):
    """``prepare``'s closest-hit inputs on the resident route, without w:
    ``(order, enter, feats, alive_i)``."""
    return prepare(o, d, alive, packed, Route(False, 0, ray_tile))[-1][:-1]


def prepare_rays_streamed(o, d, packed: PackedScene, alive=None, ray_tile: int = STREAM_RAY_TILE):
    """``prepare``'s closest-hit inputs on the streamed route: ``(order,
    enter, enter_blk, feats, alive_i, w)``, ``w`` the padded pack's."""
    return prepare(o, d, alive, packed, _streamed(packed, ray_tile))[-1]


def prepare_shadow_rays(o, d, max_t, packed: PackedScene, ray_tile: int = DEFAULT_RAY_TILE):
    """``prepare``'s any-hit inputs on the resident route, without w:
    ``(order, enter, feats, maxt)``."""
    return prepare(o, d, max_t, packed, Route(False, 0, ray_tile), any_hit=True)[-1][:-1]


def prepare_shadow_rays_streamed(o, d, max_t, packed: PackedScene, ray_tile: int = STREAM_RAY_TILE):
    """``prepare``'s any-hit inputs on the streamed route: ``(order, enter,
    enter_blk, feats, maxt, w)``."""
    return prepare(o, d, max_t, packed, _streamed(packed, ray_tile), any_hit=True)[-1]


def _regroup_stragglers(search, prepared, way: Route, best_t, best_i, done, plain: bool, **modes):
    """Phase 2 of the two-phase streamed search, as the JAX package's
    ``intersect_pallas`` runs it: the live lanes that phase 1 left undone
    are packed densely into fresh tiles (a stable partition, which keeps
    the caller's coherence order), scheduled anew and resumed from their
    partial hits with no cluster cap; tiles of finished lanes cull
    everything. ``prepared`` is ``prepare``'s, ``plain`` as there. Returns
    the merged ``(best_t, best_i)``."""
    o, d, padded, (_, _, _, feats, alive_i, w) = prepared
    how = schedule_route(o.device, plain)
    with scope("render.schedule", SCHEDULE_ROUTES.index(how)):
        undone = (alive_i > 0) & (done == 0)
        perm, inv = partition_alive(undone)
        und_p = undone[perm]
        order, enter_sorted, enter_blk = _tile_schedule(o[perm], d[perm], und_p, padded, way, how)
    with scope("render.search.closest"):
        bt2, bi2 = search(order, enter_sorted, enter_blk, feats[perm], und_p.to(torch.int32), w, way.ray_tile,
                          init_t=torch.where(und_p, best_t[perm], -INF), init_i=best_i[perm], **modes)
        return torch.where(undone, bt2[inv], best_t), torch.where(undone, bi2[inv], best_i)


def _hits(best_t, best_i, packed: PackedScene, r: int) -> Hit:
    best_t = best_t[:r]
    best_i = best_i[:r].long()
    hit = best_i >= 0
    tri = torch.where(hit, packed.tri_map[torch.clamp(best_i, min=0)], -1)
    return Hit(t=torch.where(hit, best_t, BIG), tri=tri, hit=hit)


def intersect_packed(
    o, d, packed: PackedScene, alive=None, ray_tile: int = DEFAULT_RAY_TILE, plain: bool = False,
    precision: str = "highest",
) -> Hit:
    """Closest hit of rays (R, 3) against the packed scene; ``d`` must be
    unit directions. ``tri`` holds scene rows (``tri_map`` applied).

    The pack's size picks the route and the ray tile (``route``); the
    streamed route runs the traversal modes of ``STREAM_PHASE1_BUDGET``,
    ``STREAM_SUBTILES`` (where it divides the tile) and
    ``STREAM_FRESH_WORST``: with a budget, the lanes phase 1 leaves undone
    are regrouped and resumed (``_regroup_stragglers``). ``alive`` (R,)
    bool: dead lanes are left out of the tile frustums and report no hit.
    ``plain=True`` runs the plain versions on any device, the schedule's
    torch ops too. ``precision``:
    the decision product (``resolve_precision``).

    The search is discrete: it runs on detached rays and the ``Hit`` never
    carries autograd history (``resolve_hits`` re-derives the attributes).
    Its schedule runs in ``render.schedule`` spans and its launches and
    hits in ``render.search.closest`` spans; a traced frame's test counter
    (``utils.profiling.frame_tests``) takes the tests computed.
    """
    o, d = o.detach(), d.detach()
    precision = resolve_precision(precision)
    tests = frame_tests()
    way = route(packed.w.shape[0], packed.tri_block, ray_tile)
    prepared = prepare(o, d, alive, packed, way, plain=plain)
    modes = {"precision": precision, "tests": tests}
    search = closest_hit_reference if plain else closest_hit
    if way.streamed:
        search = closest_hit_streamed_reference if plain else closest_hit_streamed
        modes.update(fresh=STREAM_FRESH_WORST,
                     subtiles=STREAM_SUBTILES if way.ray_tile % max(STREAM_SUBTILES, 1) == 0 else 1)
    if way.streamed and STREAM_PHASE1_BUDGET > 0:
        with scope("render.search.closest"):
            best_t, best_i, done = search(*prepared[-1], way.ray_tile, budget=STREAM_PHASE1_BUDGET, with_done=True,
                                          **modes)
        best_t, best_i = _regroup_stragglers(search, prepared, way, best_t, best_i, done, plain, **modes)
        with scope("render.search.closest"):
            return _hits(best_t, best_i, packed, o.shape[0])
    with scope("render.search.closest"):
        best_t, best_i = search(*prepared[-1], way.ray_tile, **modes)
        return _hits(best_t, best_i, packed, o.shape[0])


def intersect_packed_occluded(
    o, d, max_t, packed: PackedScene, ray_tile: int = DEFAULT_RAY_TILE, plain: bool = False,
    precision: str = "highest",
) -> torch.Tensor:
    """Occlusion of rays (R, 3) with unit directions: (R,) bool, True where
    some accepted hit has t in (EPSILON, ``max_t``). ``max_t = 0`` marks
    lanes that need no test; they report False. The route, the ray tile,
    ``plain`` and ``precision`` as in ``intersect_packed``; the rays and
    cutoffs are detached. On the streamed route a traced frame's any-hit
    counter (``utils.profiling.frame_anyhit_tests``) takes the tests of the
    blocks tested; the resident route counts none."""
    o, d, max_t = o.detach(), d.detach(), max_t.detach()
    precision = resolve_precision(precision)
    way = route(packed.w.shape[0], packed.tri_block, ray_tile)
    search, count = (occluded_reference if plain else occluded), {}
    if way.streamed:
        search, count = (occluded_streamed_reference if plain else occluded_streamed), {"tests": frame_anyhit_tests()}
    inputs = prepare(o, d, max_t, packed, way, any_hit=True, plain=plain)[-1]
    with scope("render.search.any"):
        return search(*inputs, way.ray_tile, precision=precision, **count)[: o.shape[0]] > 0


def make_sorted_intersect(intersect_fn, packed: PackedScene, key_mode: str = "dir", precision: str | None = None):
    """Wrap a closest-hit function ``(o, d, alive=None) -> Hit`` with a sort
    of its rays for tile coherence, as the JAX package's
    ``make_sorted_intersect``: the key is (direction octant, direction
    Morton, origin Morton) for ``"dir"`` and (octant, origin Morton,
    direction Morton) for ``"origin"``, the origin box is the pack's, and
    results are scattered back to the caller's order. A ``precision`` is
    passed on to ``intersect_fn`` as its keyword (None: the function's
    own). The rays are detached on entry, as the search needs no
    gradient."""
    if key_mode not in ("dir", "origin"):
        raise ValueError(f"unknown sort key {key_mode!r}")
    kw = {} if precision is None else {"precision": resolve_precision(precision)}
    lo = packed.box_lo.amin(dim=0)
    hi = packed.box_hi.amax(dim=0)

    def wrapped(o, d, alive=None) -> Hit:
        o, d = o.detach(), d.detach()
        with scope("render.compact"):
            octant = (d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long() + 4 * (d[:, 2] < 0).long()
            dm = morton_codes(d, d.new_full((3,), -1.0), d.new_full((3,), 1.0))
            om = morton_codes(o, lo, hi)
            if key_mode == "origin":
                key = (octant << 28) | ((om >> 15) << 13) | (dm >> 17)
            else:
                key = (octant << 27) | ((dm >> 18) << 15) | (om >> 15)
            perm = torch.argsort(key, stable=True)
            o, d, alive = o[perm], d[perm], None if alive is None else alive[perm]
        h = intersect_fn(o, d, alive=alive, **kw)
        with scope("render.compact"):
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(perm.shape[0], device=perm.device)
            return Hit(t=h.t[inv], tri=h.tri[inv], hit=h.hit[inv])

    return wrapped
