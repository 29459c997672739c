"""A packed search's schedule as one CUDA launch (``csrc/schedule.cu``).

``tile_schedule`` computes on CUDA tensors what ``packed_intersect.prepare``
computes with torch ops for one search: the ray features (``pack_rays``)
and lane values padded to whole ray tiles, each tile's block cull
(``tile_block_mask``) and its block order (``plan_block_order``) or, on the
streamed route, its cluster order and per-block entry bounds
(``cluster_schedule``). On the card it is one launch in place of ~70
dispatched torch ops, with the same numbers bit for bit (the kernel's
source says how). ``packed_intersect.schedule_route`` picks it for every
search on the card; it has no backward (the schedule is discrete, and its
rays are detached).

The launch runs inside an op of the dispatcher (``firefly_schedule::prepare``,
CUDA tensors only), so that ``torch.profiler`` links the kernel to the
caller's ``render.schedule`` span, as the shade step's launch is linked
(``ops/shade.py``). ``_build.launch_counts["schedule"]`` counts launches.
"""

from __future__ import annotations

import torch

from gpupathtracer_tpu_torch.ops import _build
from gpupathtracer_tpu_torch.ops.plucker import K

# The most keys (blocks on the resident route, clusters on the streamed one)
# the kernel sorts a tile in shared memory (csrc/schedule.cu's SHARED_KEYS);
# a tile of more sorts in a global scratch that the wrapper allocates.
SHARED_KEYS = 2048

# The kernel's lane input kinds (csrc/schedule.cu): every lane live, the
# closest hit's alive as bool or int32, the any hit's float32 cutoffs.
LANES_ALL, LANES_BOOL, LANES_INT, LANES_CUTOFF = 0, 1, 2, 3


def _prepare_launch(o, d, lanes, box_lo, box_hi, block_live, bpc: int, ray_tile: int, any_hit: bool, rays: bool):
    r, dev = d.shape[0], d.device
    f32, i32, kernel = torch.float32, torch.int32, "the schedule kernel"
    if o.dtype != f32 or o.shape != (r, 3) or o.stride(1) != 1 or o.stride(0) not in (0, 3) or o.device != dev:
        raise ValueError(f"{kernel} takes o as float32 (R, 3) on {dev} with rows 0 or 3 floats apart")
    nb = box_lo.shape[0]
    if lanes is None:
        if any_hit:
            raise ValueError(f"{kernel} takes the any hit's cutoffs")
        kind = LANES_ALL
    elif any_hit:
        kind = LANES_CUTOFF
        _build.check(kernel, lanes, "the cutoffs", f32, (r,), dev)
    else:
        kind = LANES_BOOL if lanes.dtype == torch.bool else LANES_INT
        _build.check(kernel, lanes, "alive", torch.bool if kind == LANES_BOOL else i32, (r,), dev)
    for x, what, dtype, shape in ((d, "d", f32, (r, 3)), (box_lo, "box_lo", f32, (nb, 3)),
                                  (box_hi, "box_hi", f32, (nb, 3)), (block_live, "block_live", torch.bool, (nb,))):
        _build.check(kernel, x, what, dtype, shape, dev)
    step = bpc if bpc > 0 else 1
    if ray_tile < 1:
        raise ValueError(f"{kernel} takes ray_tile >= 1, got {ray_tile}")
    if nb < 1 or nb % step:
        raise ValueError(f"{kernel} takes whole clusters of at least one block: {nb} blocks in clusters of {step}")
    rt = -(-r // ray_tile)
    r_pad, nkeys = rt * ray_tile, nb // step
    sort_n = 1 << (nkeys - 1).bit_length()
    scratch = torch.empty((rt * (8 * sort_n + 4 * nkeys),), dtype=torch.uint8, device=dev) \
        if nkeys > SHARED_KEYS else None
    padded = rays and r_pad != r
    order = torch.empty((rt, nkeys), dtype=i32, device=dev)
    enter = torch.empty((rt, nkeys), dtype=f32, device=dev)
    enter_blk = torch.empty((rt, nb) if bpc > 0 else (0,), dtype=f32, device=dev)
    feats = torch.empty((r_pad if rays else 0, K), dtype=f32, device=dev)
    lanes_out = torch.empty((r_pad if rays else 0,), dtype=f32 if any_hit else i32, device=dev)
    o_pad = torch.empty((r_pad if padded else 0, 3), dtype=f32, device=dev)
    d_pad = torch.empty((r_pad if padded else 0, 3), dtype=f32, device=dev)
    if rt:
        some = lambda x, used: x if used else None
        _build.launch(_build.SCHEDULE, "tile_schedule_launch", dev, o, o.stride(0), d, lanes, kind, box_lo, box_hi,
                      block_live, order, enter, some(enter_blk, bpc > 0), some(feats, rays), some(lanes_out, rays),
                      some(o_pad, padded), some(d_pad, padded), scratch, r, rt, ray_tile, nb, step)
    return order, enter, enter_blk, feats, lanes_out, o_pad, d_pad


_OPS = torch.library.Library("firefly_schedule", "DEF")
_OPS.define("prepare(Tensor o, Tensor d, Tensor? lanes, Tensor box_lo, Tensor box_hi, Tensor block_live, int bpc, "
            "int ray_tile, bool any_hit, bool rays) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_OPS.impl("prepare", _prepare_launch, "CUDA")
_prepare_kernel = torch.ops.firefly_schedule.prepare.default


def tile_schedule(o, d, lanes, packed, bpc: int, ray_tile: int, any_hit: bool = False, rays: bool = True):
    """One launch of a search's schedule for rays (R, 3) float32 with unit
    directions, in tiles of ``ray_tile`` (the last padded), against the
    blocks of ``packed`` (on the streamed route padded to whole clusters of
    ``bpc``; ``bpc`` = 0 on the resident route). ``lanes`` is None (every
    lane live), the closest hit's alive (bool or int32) or with ``any_hit``
    the cutoffs (float32); a lane is live where it is > 0. Returns ``(order,
    enter_sorted, enter_blk, feats, lanes, o, d)``: the schedule as
    ``plan_block_order`` or ``cluster_schedule`` gives it (``enter_blk``
    empty on the resident route), then with ``rays`` the padded features and
    lane values (int32, or float32 cutoffs) and, where R needs padding, the
    padded o and d (else empty, as is what ``rays=False`` leaves out).
    CUDA tensors only; raises on what the kernel does not take."""
    if o.stride(-1) != 1 or o.stride(0) not in (0, 3):
        o = o.contiguous()  # the kernel reads rows 3 floats apart, or the camera's one expanded row
    if not d.is_contiguous():
        d = d.contiguous()
    if lanes is not None and not lanes.is_contiguous():
        lanes = lanes.contiguous()
    return _prepare_kernel(o, d, lanes, packed.box_lo, packed.box_hi, packed.block_live, bpc, ray_tile, any_hit,
                           rays)
