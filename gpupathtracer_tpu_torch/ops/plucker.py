"""Plücker-coordinate ray features for the packed closest-hit search.

Counterpart of ``gpupathtracer_tpu/ops/plucker.py``. For a ray (o, d) with
moment m = o × d and a triangle edge PQ, side = d·(P×Q) + m·(Q−P) is
bilinear in the ray features [d, m] and the edge columns [P×Q, Q−P], and
the plane terms N·d and c − N·o come from the same product. So every
(ray, triangle) decision scalar [s0, s1, s2, N·d, c − N·o] is one dot
product of a ray feature row with a packed triangle column
(``ops/packed_intersect.py`` builds the columns).
"""

from __future__ import annotations

import torch

K = 16  # ray/triangle feature depth (10 used, zero-padded)
NSCALARS = 5  # s0, s1, s2, D = N·d, num = c − N·o

# The (scalar, feature row) slots of a packed triangle column that can be
# nonzero, in the order the streamed kernels sum them (scalar by scalar,
# rows ascending): the edge scalars s0, s1, s2 read [d, o×d] (rows 0–5), D
# reads d (rows 0–2) and num reads [o, 1] (rows 6–9). ``pack_scene`` leaves
# every other slot of ``w`` exactly zero, and ``pack_rays`` leaves feature
# rows 10–15 zero. The streamed kernels (``csrc/stream_stage.cuh``) stage
# and multiply only these 25 slots, and rely on both.
LIVE_SLOTS = (
    tuple((s, k) for s in range(3) for k in range(6))
    + tuple((3, k) for k in range(3))
    + tuple((4, k) for k in range(6, 10))
)


def pack_rays(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Rays (R, 3), (R, 3) → feature rows (R, K) = [d, o×d, o, 1, 0...]."""
    r = o.shape[0]
    feats = torch.zeros((r, K), dtype=torch.float32, device=o.device)
    feats[:, 0:3] = d
    feats[:, 3:6] = torch.linalg.cross(o, d)
    feats[:, 6:9] = o
    feats[:, 9] = 1.0
    return feats
