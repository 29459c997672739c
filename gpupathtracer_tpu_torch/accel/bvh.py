"""Flattened stackless BVH: the host builder and a batched traversal.

Counterpart of ``gpupathtracer_tpu/accel/bvh.py``.

- **Builder** (numpy, on the host; ``native.build_bvh_native`` is its C++
  twin): median split on the longest centroid axis (stable), nodes in
  depth-first order with the left child at ``i + 1``, and escape (miss)
  links: on a box hit a traversal goes on to node ``i + 1``, on a miss it
  jumps to ``miss[i]``. Leaves own contiguous runs of ``tri_order``. The
  arrays equal the JAX package's element for element.
- **Traversal** (``intersect_bvh``): the JAX package's per-ray
  ``while_loop`` run for all rays at once. Each lane carries (node, best_t,
  best_i) and is done when its node reaches ``num_nodes``; finished lanes
  are dropped every ``_COMPACT_EVERY`` steps, which is also the only point
  where the host waits for the device. Plain PyTorch: the JAX traversal is
  jnp, not a Pallas kernel, so there is no kernel to port.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops.intersect import BIG, EPSILON, Hit, mt_pairs

# Traversal steps between two drops of finished lanes (each drop syncs).
_COMPACT_EVERY = 8


@dataclasses.dataclass(frozen=True)
class Bvh:
    """Flattened threaded BVH over a TriangleScene's rows."""

    box_lo: torch.Tensor  # (M, 3) float32
    box_hi: torch.Tensor  # (M, 3) float32
    first: torch.Tensor  # (M,) int64 — leaf: first triangle slot; inner: -1
    count: torch.Tensor  # (M,) int64 — leaf: triangle count; inner: 0
    miss: torch.Tensor  # (M,) int64 — escape link (M = done)
    tri_order: torch.Tensor  # (S,) int64 — slot -> scene row; -1 pads S to a multiple of leaf_size
    leaf_size: int = 8

    @property
    def num_nodes(self) -> int:
        return self.box_lo.shape[0]


def bvh_from_arrays(box_lo, box_hi, first, count, miss, tri_order, leaf_size: int, device) -> Bvh:
    """A ``Bvh`` on ``device`` from the builder's numpy arrays (float32
    boxes, int32 indices)."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    return Bvh(box_lo=f32(box_lo), box_hi=f32(box_hi), first=i64(first), count=i64(count), miss=i64(miss),
               tri_order=i64(tri_order), leaf_size=leaf_size)


def _host_geometry(scene: TriangleScene):
    host = lambda x: x.detach().cpu().numpy()
    return host(scene.v0), host(scene.e1), host(scene.e2), host(scene.valid)


def build_bvh(scene: TriangleScene, leaf_size: int = 8) -> Bvh:
    """Host median-split builder; the ``Bvh`` lands on the scene's device."""
    v0, e1, e2, valid = _host_geometry(scene)
    rows = np.where(valid)[0].astype(np.int32)
    if rows.size == 0:
        rows = np.zeros((1,), np.int32)

    p0 = v0[rows]
    p1 = v0[rows] + e1[rows]
    p2 = v0[rows] + e2[rows]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    cent = (lo + hi) * 0.5

    box_lo, box_hi, first, count = [], [], [], []
    order: list[np.ndarray] = []
    slots = [0]  # slots emitted so far (the JAX builder sums the leaves' sizes at each leaf)

    def emit(idxs: np.ndarray) -> int:
        """Depth-first emit; returns this subtree's root node id."""
        node = len(box_lo)
        box_lo.append(lo[idxs].min(axis=0))
        box_hi.append(hi[idxs].max(axis=0))
        first.append(-1)
        count.append(0)
        if idxs.size <= leaf_size:
            first[node] = slots[0]
            count[node] = idxs.size
            order.append(idxs)
            slots[0] += idxs.size
            return node
        axis = int(np.argmax(cent[idxs].max(0) - cent[idxs].min(0)))
        med = np.argsort(cent[idxs, axis], kind="stable")
        half = idxs.size // 2
        emit(idxs[med[:half]])
        emit(idxs[med[half:]])
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        emit(np.arange(rows.size))
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(box_lo)
    count_a = np.asarray(count, np.int32)
    # Escape links: in DFS order a node's subtree occupies [i, i + size_i),
    # children contiguous (left = i + 1, right = left + size(left)).
    size = np.ones((m,), np.int32)
    for i in range(m - 1, -1, -1):
        if count_a[i] == 0:
            left = i + 1
            size[i] = 1 + size[left] + size[left + size[left]]
    miss = np.arange(m, dtype=np.int32) + size

    tri_order = rows[np.concatenate(order)] if order else rows[:0]
    pad = (-tri_order.size) % max(leaf_size, 1)
    if pad:
        tri_order = np.concatenate([tri_order, np.full((pad,), -1, np.int32)])
    return bvh_from_arrays(box_lo, box_hi, first, count_a, miss, tri_order, leaf_size, scene.v0.device)


def intersect_bvh(o: torch.Tensor, d: torch.Tensor, scene: TriangleScene, bvh: Bvh, t_min: float = EPSILON) -> Hit:
    """Closest hit of rays (R, 3) by stackless traversal, with the JAX
    package's per-ray semantics: ``inv_d = 1 / d`` with components below
    1e-20 in magnitude set to +1e-20 (their sign dropped), the slab test
    ``enter <= exit & exit > 0 & enter < best_t``, and at a hit leaf
    Möller–Trumbore over its ``leaf_size`` slots (pads and invalid rows
    masked), the first slot winning ties and the running best replaced only
    on strict ``<``. The search is detached: the ``Hit`` carries no
    gradient."""
    o, d = o.detach(), d.detach()
    dev, r = o.device, o.shape[0]
    v0, e1, e2 = (x.detach() for x in (scene.v0, scene.e1, scene.e2))
    m, leaf, n_slots = bvh.num_nodes, bvh.leaf_size, bvh.tri_order.shape[0]
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
    slot = torch.arange(leaf, device=dev)

    lanes = torch.arange(r, device=dev)
    o_a, d_a = o, d
    inv_a = 1.0 / torch.where(d.abs() < 1e-20, 1e-20, d)
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    bt, bi = best_t.clone(), best_i.clone()
    while lanes.numel():
        for _ in range(_COMPACT_EVERY):
            live = node < m
            nc = node.clamp(max=m - 1)
            t0 = (bvh.box_lo[nc] - o_a) * inv_a
            t1 = (bvh.box_hi[nc] - o_a) * inv_a
            enter = torch.minimum(t0, t1).amax(dim=-1)
            exit_ = torch.maximum(t0, t1).amin(dim=-1)
            hit_box = live & (enter <= exit_) & (exit_ > 0.0) & (enter < bt)
            cnt = bvh.count[nc]
            is_leaf = cnt > 0
            in_leaf = slot[None, :] < cnt[:, None]
            tri = bvh.tri_order[(bvh.first[nc][:, None] + slot[None, :]).clamp(0, n_slots - 1)]
            tri = torch.where(in_leaf, tri, 0)
            ok_row = in_leaf & (tri >= 0) & scene.valid[tri.clamp(min=0)]
            tc = tri.clamp(min=0)
            t, ok = mt_pairs(o_a, d_a, v0[tc], e1[tc], e2[tc], scene.two_sided[tc], t_min)
            tmin, j = torch.where(ok & ok_row, t, BIG).min(dim=1)  # the first slot wins ties
            upd = hit_box & is_leaf & (tmin < bt)
            bt = torch.where(upd, tmin, bt)
            bi = torch.where(upd, tri.gather(1, j[:, None])[:, 0], bi)
            node = torch.where(live, torch.where(hit_box & ~is_leaf, nc + 1, bvh.miss[nc]), node)
        best_t[lanes], best_i[lanes] = bt, bi
        keep = torch.nonzero(node < m).flatten()  # the one sync of the round
        lanes, o_a, d_a, inv_a, node, bt, bi = (x[keep] for x in (lanes, o_a, d_a, inv_a, node, bt, bi))
    return Hit(t=best_t, tri=best_i, hit=best_i >= 0)
