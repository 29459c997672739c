"""``kind = "sphere"``: an icosphere, subdivided from the icosahedron,
every new vertex the normalised float64 midpoint of its edge, then rounded
to float32, scaled by ``radius`` and moved to ``position``; one-sided."""

from __future__ import annotations

import numpy as np

from h100_bench.reference.scene import triples


def icosphere(subdivisions: int) -> np.ndarray:
    """(F, 3, 3) float32 triangles of the unit icosphere, faces in the order
    of repeated 1-to-4 splits (each face's children in turn: the corner
    triangles at a, b, c, then the middle one)."""
    g = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array(
        [[-1, g, 0], [1, g, 0], [-1, -g, 0], [1, -g, 0], [0, -1, g], [0, 1, g],
         [0, -1, -g], [0, 1, -g], [g, 0, -1], [g, 0, 1], [-g, 0, -1], [-g, 0, 1]],
        np.float64,
    )
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        np.int64,
    )
    for _ in range(subdivisions):
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])  # ab, bc, ca of every face
        key = np.sort(edges, axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        m = v[uniq[:, 0]] + v[uniq[:, 1]]
        m = m / np.linalg.norm(m, axis=1, keepdims=True)
        mid = inv + len(v)
        n = len(f)
        ab, bc, ca = mid[:n], mid[n:2 * n], mid[2 * n:]
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.stack(
            [np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1), np.stack([c, ca, bc], 1),
             np.stack([ab, bc, ca], 1)], 1,
        ).reshape(-1, 3)
        v = np.concatenate([v, m])
    return v.astype(np.float32)[f]


def triangles(g: dict):
    if tuple(triples(g.get("rotation_deg"), (0, 0, 0))) != (0.0, 0.0, 0.0):
        raise ValueError("the reference places spheres without rotation")
    r = np.float32(g.get("radius", 1.0))
    pos = np.asarray(triples(g.get("position"), (0.0, 0.0, 0.0)), np.float32)
    return icosphere(int(g.get("subdivisions", 3))) * r + pos, False
