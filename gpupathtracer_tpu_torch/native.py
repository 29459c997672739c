"""ctypes bindings for the port's host (C++) builders, ``csrc/firefly_native.cpp``.

Counterpart of ``gpupathtracer_tpu/native.py``. The library is compiled at
first use by ``ops/_build.build_host`` into the package's ``build/``
directory and holds the OBJ parser, the BVH builder and the edge-table
builder. Each gives the Python builder's arrays exactly (``models/obj.py``,
``accel/bvh.py``, ``grad/edges.py``; ``tests/test_torch_native.py``).

No fallback: when the library cannot be built, every builder here raises
with the compiler's message. ``available()`` only answers whether it can be
built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from gpupathtracer_tpu_torch.ops import _build

_lib = None


def build_library(force: bool = False) -> str:
    """Compile the library unless it is built already (``force`` rebuilds);
    returns its path. Raises RuntimeError with the compiler's message."""
    path = _build.host_library_path()
    if force or not os.path.exists(path):
        path = _build.build_host()
    return path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    f32, i32, u8 = (np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS") for t in (np.float32, np.int32, np.uint8))
    lib.obj_load.restype = ctypes.c_void_p
    lib.obj_load.argtypes = [ctypes.c_char_p]
    lib.obj_num_triangles.restype = ctypes.c_int
    lib.obj_num_triangles.argtypes = [ctypes.c_void_p]
    lib.obj_fill.argtypes = [ctypes.c_void_p, f32, f32, f32]
    lib.obj_free.argtypes = [ctypes.c_void_p]
    lib.bvh_build.restype = ctypes.c_int
    # v0, e1, e2, valid, n, leaf_size, box_lo, box_hi, first, count, miss, order, max_nodes
    lib.bvh_build.argtypes = [f32, f32, f32, u8, ctypes.c_int, ctypes.c_int, f32, f32, i32, i32, i32, i32,
                              ctypes.c_int]
    lib.edge_table_build.restype = ctypes.c_int
    # v0, e1, e2, valid, n, quantization step, tri1, corner, tri2
    lib.edge_table_build.argtypes = [f32, f32, f32, u8, ctypes.c_int, ctypes.c_double, i32, i32, i32]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is built or can be built here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def load_obj_native(path: str):
    """Native OBJ parse → ``models.obj.MeshData``."""
    from gpupathtracer_tpu_torch.models.obj import MeshData

    lib = _load()
    h = lib.obj_load(os.fspath(path).encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        t = lib.obj_num_triangles(h)
        v = np.empty((t, 3, 3), np.float32)
        n = np.empty((t, 3, 3), np.float32)
        uv = np.empty((t, 3, 2), np.float32)
        if t:
            lib.obj_fill(h, v.reshape(-1), n.reshape(-1), uv.reshape(-1))
        return MeshData(vertices=v, normals=n, uvs=uv)
    finally:
        lib.obj_free(h)


def _host_arrays(scene):
    host = lambda x, dt: np.ascontiguousarray(x.detach().cpu().numpy(), dt)
    return (host(scene.v0, np.float32), host(scene.e1, np.float32), host(scene.e2, np.float32),
            host(scene.valid, np.uint8))


def build_edge_table_native(scene):
    """Native edge-table build → ``grad.edges.EdgeTable``, equal to the
    Python builder's (the same quantization and first-encounter order)."""
    from gpupathtracer_tpu_torch.grad.edges import EdgeTable

    lib = _load()
    v0, e1, e2, valid = _host_arrays(scene)
    two = scene.two_sided.detach().cpu().numpy()
    n = v0.shape[0]
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    pts = corners[valid.astype(bool)].reshape(-1, 3)
    diag = float(np.linalg.norm(pts.max(0) - pts.min(0))) if pts.size else 1.0
    q = 1e-5 * max(diag, 1e-12)
    cap = 3 * max(n, 1)
    tri1, corner, tri2 = (np.empty((cap,), np.int32) for _ in range(3))
    m = lib.edge_table_build(v0.reshape(-1), e1.reshape(-1), e2.reshape(-1), valid, n, q, tri1, corner, tri2)
    tri1, corner, tri2 = tri1[:m].copy(), corner[:m].copy(), tri2[:m].copy()
    return EdgeTable(tri1=tri1, corner=corner, tri2=tri2, two_sided=two[tri1])


def build_bvh_native(scene, leaf_size: int = 8):
    """Native BVH build → ``accel.bvh.Bvh`` on the scene's device, equal to
    ``accel.bvh.build_bvh``'s."""
    from gpupathtracer_tpu_torch.accel.bvh import bvh_from_arrays

    lib = _load()
    v0, e1, e2, valid = _host_arrays(scene)
    n = v0.shape[0]
    n_real = max(int(valid.sum()), 1)
    max_nodes = 2 * n_real + 2
    box_lo = np.empty((max_nodes, 3), np.float32)
    box_hi = np.empty((max_nodes, 3), np.float32)
    first, count, miss = (np.empty((max_nodes,), np.int32) for _ in range(3))
    order = np.empty((n_real,), np.int32)
    m = lib.bvh_build(v0.reshape(-1), e1.reshape(-1), e2.reshape(-1), valid, n, leaf_size,
                      box_lo.reshape(-1), box_hi.reshape(-1), first, count, miss, order, max_nodes)
    if m < 0:
        raise RuntimeError("bvh_build failed (node budget exceeded)")
    pad = (-order.size) % max(leaf_size, 1)
    if pad:
        order = np.concatenate([order, np.full((pad,), -1, np.int32)])
    return bvh_from_arrays(box_lo[:m], box_hi[:m], first[:m], count[:m], miss[:m], order, leaf_size,
                           scene.v0.device)
