"""``kind = "plane"``: the unit square at the origin, two triangles,
two-sided, placed by the model matrix ``T * Rx * Ry * Rz * S``."""

from __future__ import annotations

import math

import numpy as np

from h100_bench.reference.scene import triples

_PLANE = np.array(
    [[[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0]],
     [[-0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]]],
    np.float32,
)


def _model_matrix(position, rotation_deg, scale) -> np.ndarray:
    """T * Rx * Ry * Rz * S in float64 (column vectors)."""

    def rot(deg, i, j):
        r = np.eye(4)
        c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
        r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
        return r

    t = np.eye(4)
    t[:3, 3] = position
    return t @ rot(rotation_deg[0], 1, 2) @ rot(rotation_deg[1], 2, 0) @ rot(rotation_deg[2], 0, 1) @ np.diag(
        list(scale) + [1.0])


def triangles(g: dict):
    m = _model_matrix(triples(g.get("position"), (0.0, 0.0, 0.0)), triples(g.get("rotation_deg"), (0, 0, 0)),
                      triples(g.get("scale"), (1, 1, 1)))
    return (_PLANE.astype(np.float64) @ m[:3, :3].T + m[:3, 3]).astype(np.float32), True
