"""The port's host (C++) builders (``native.py``,
``csrc/firefly_native.cpp``) against its Python builders, which equal the
JAX package's: the OBJ loader, the BVH (leaf sizes 4, 8 and 16) and the
edge table, array for array, on an icosphere and on a triangle soup with
duplicated triangles; and ``build_edge_table(native=True)`` raising with
the compiler's message when the library cannot be built."""

import numpy as np
import pytest
import torch

from gpupathtracer_tpu.grad import edges as je
from gpupathtracer_tpu.models.obj import load_obj as j_load_obj
from gpupathtracer_tpu_torch import native
from gpupathtracer_tpu_torch.accel.bvh import build_bvh
from gpupathtracer_tpu_torch.grad.edges import build_edge_table
from gpupathtracer_tpu_torch.models.obj import MeshData, load_obj
from gpupathtracer_tpu_torch.models.scene import build_scene, icosphere, mesh_spec, plane_spec
from gpupathtracer_tpu_torch.ops import _build

OBJ = """# faces of every form, negative indices, a quad and a pentagon
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0.5
v -0.25 0.75 1.125
vt 0 0
vt 1 0
vt 1 1
vt 0.5
vn 0 0 1
vn 0 1 0
f 1 2 3
f 1/1 3/3 4/4
f 1//1 2//2 3//1
f 1/1/1 2/2/2 3/3/1 4/4/2
f -5 -4 -3 -2 -1
  f 2/2 4/4 5/1
"""


def _icosphere_scene():
    return build_scene([mesh_spec(icosphere(3)), plane_spec((0, 0, -2), (0, 0, 0), (5, 5, 5))],
                       [{"type": "diffuse"}], pad_to_multiple=128, device="cpu")


def _soup_scene():
    """Random triangles welded at shared positions, every tenth one repeated
    (edges with more than two faces) and some two-sided."""
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(60, 3)).astype(np.float32)
    tris = pts[rng.integers(0, 60, size=(300, 3))]
    tris = np.concatenate([tris, tris[::10]])
    mesh = lambda t: MeshData(vertices=t, normals=np.zeros_like(t), uvs=np.zeros((t.shape[0], 3, 2), np.float32))
    return build_scene([mesh_spec(mesh(tris[:250])), mesh_spec(mesh(tris[250:]), two_sided=True)],
                       [{"type": "diffuse"}], pad_to_multiple=128, device="cpu")


SCENES = {"icosphere": _icosphere_scene, "soup": _soup_scene}


def test_native_obj_equals_python(tmp_path):
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ)
    py, nat, jx = load_obj(path), native.load_obj_native(str(path)), j_load_obj(path)
    assert nat.num_triangles == py.num_triangles == 9
    for f in ("vertices", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(nat, f), getattr(py, f), err_msg=f)
        np.testing.assert_array_equal(getattr(py, f), getattr(jx, f), err_msg=f)


def test_native_obj_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.load_obj_native(str(tmp_path / "absent.obj"))


@pytest.mark.parametrize("leaf_size", [4, 8, 16])
@pytest.mark.parametrize("name", list(SCENES))
def test_native_bvh_equals_python(name, leaf_size):
    scene = SCENES[name]()
    py, nat = build_bvh(scene, leaf_size=leaf_size), native.build_bvh_native(scene, leaf_size=leaf_size)
    assert nat.num_nodes == py.num_nodes and nat.leaf_size == leaf_size
    for f in ("box_lo", "box_hi", "first", "count", "miss", "tri_order"):
        assert torch.equal(getattr(nat, f), getattr(py, f)), f


@pytest.mark.parametrize("name", list(SCENES))
def test_native_edge_table_equals_python_and_jax(name):
    scene = SCENES[name]()
    py, nat = build_edge_table(scene, native=False), build_edge_table(scene)
    from gpupathtracer_tpu_torch.interop import numpy_fields

    class _Host:  # the JAX builder reads the scene's arrays with np.asarray
        pass

    host = _Host()
    for f, v in numpy_fields(scene, ["v0", "e1", "e2", "valid", "two_sided"]).items():
        setattr(host, f, v)
    jx = je.build_edge_table(host, native=False)
    assert nat.num_edges > 0 and (nat.tri2 >= 0).any()
    for f in ("tri1", "corner", "tri2", "two_sided"):
        np.testing.assert_array_equal(getattr(nat, f), getattr(py, f), err_msg=f)
        np.testing.assert_array_equal(getattr(py, f), getattr(jx, f), err_msg=f)


def test_native_true_raises_when_the_compiler_fails(tmp_path, monkeypatch):
    """No fallback to the Python loop: a failing build raises with the
    compiler's message."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "HOST_CXX_FLAGS", _build.HOST_CXX_FLAGS + ["-fno-such-compiler-flag"])
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-compiler-flag"):
        build_edge_table(_icosphere_scene())
    assert not native.available()
    assert list(tmp_path.iterdir()) == []  # no partial library left behind
