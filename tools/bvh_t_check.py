"""Why the port's BVH hit distances differ from the JAX package's in the
last bits on the CPU.

    python3 tools/bvh_t_check.py

Runs both traversals on tests/test_torch_bvh.py's random scene (seed 3,
500 rays, leaf size 8), then recomputes each hit's Möller–Trumbore t in
numpy under three roundings: plain float32, the cross products contracted
into FMAs (fma(a1, b2, -(a2 * b1))), and the cross and dot products both
contracted (the dots as fma(a2, b2, fma(a1, b1, a0 * b0))); an FMA is
emulated in float64. Prints the share of hits whose t each rounding
reproduces for each package, and whether torch's CPU cross product is the
contracted one. About 10 s on the CPU (one JAX compile).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_bvh import random_scene, to_port  # noqa: E402

from gpupathtracer_tpu.accel import bvh as jbvh  # noqa: E402
from gpupathtracer_tpu_torch.accel import bvh as tbvh  # noqa: E402


def fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def cross(a, b):
    return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1], a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


def cross_fma(a, b):
    return np.stack([fma(a[:, 1], b[:, 2], -(a[:, 2] * b[:, 1])), fma(a[:, 2], b[:, 0], -(a[:, 0] * b[:, 2])),
                     fma(a[:, 0], b[:, 1], -(a[:, 1] * b[:, 0]))], -1)


def dot(a, b):
    p = a * b
    return (p[:, 0] + p[:, 1]) + p[:, 2]


def dot_fma(a, b):
    return fma(a[:, 2], b[:, 2], fma(a[:, 1], b[:, 1], a[:, 0] * b[:, 0]))


def main():
    js, o, d = random_scene(seed=3)
    want = jbvh.intersect_bvh(jnp.asarray(o), jnp.asarray(d), js, jbvh.build_bvh(js, leaf_size=8))
    scene = to_port(js)
    got = tbvh.intersect_bvh(torch.as_tensor(o), torch.as_tensor(d), scene, tbvh.build_bvh(scene, leaf_size=8))
    hit = got.hit.numpy()
    k = got.tri.numpy()[hit]
    v0, e1, e2 = (np.asarray(x)[k] for x in (js.v0, js.e1, js.e2))
    oo, dd = o[hit], d[hit]
    print(f"hits {int(hit.sum())}, same rows {bool((got.tri.numpy() == np.asarray(want.tri)).all())}, "
          f"t equal on {(got.t.numpy()[hit] == np.asarray(want.t)[hit]).mean():.4f} of hits")
    for name, cr, dt in (("plain", cross, dot), ("FMA cross", cross_fma, dot), ("FMA cross and dot", cross_fma, dot_fma)):
        pvec = cr(dd, e2)
        inv = np.float32(1.0) / dt(e1, pvec)
        t = dt(e2, cr(oo - v0, e1)) * inv
        print(f"{name}: reproduces the port's t on {(got.t.numpy()[hit] == t).mean():.4f}, "
              f"JAX's on {(np.asarray(want.t)[hit] == t).mean():.4f}")
    a, b = torch.randn(100000, 3), torch.randn(100000, 3)
    c = torch.linalg.cross(a, b).numpy()
    print(f"torch CPU cross == plain: {bool((c == cross(a.numpy(), b.numpy())).all())}, "
          f"== FMA: {bool((c == cross_fma(a.numpy(), b.numpy())).all())}")


if __name__ == "__main__":
    main()
