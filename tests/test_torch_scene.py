"""The port's scene, camera and config layer against the JAX package:
the same config files and spec lists load to equal fields, and primary rays
match."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.models import obj as j_obj
from gpupathtracer_tpu.models import scene as j_scene
from gpupathtracer_tpu.models.camera import Camera as JCamera
from gpupathtracer_tpu.models.camera import generate_rays_for_pixels as j_rays
from gpupathtracer_tpu.render.renderer import narrow_settings as j_narrow
from gpupathtracer_tpu.render.renderer import scene_material_set as j_material_set
from gpupathtracer_tpu.utils.config import load_scene_file as j_load
from gpupathtracer_tpu_torch import interop
from gpupathtracer_tpu_torch.models import obj as t_obj
from gpupathtracer_tpu_torch.models import scene as t_scene
from gpupathtracer_tpu_torch.models.camera import generate_rays_for_pixels as t_rays
from gpupathtracer_tpu_torch.models.materials import MaterialTable
from gpupathtracer_tpu_torch.render.renderer import narrow_settings as t_narrow
from gpupathtracer_tpu_torch.render.renderer import scene_material_set as t_material_set
from gpupathtracer_tpu_torch.utils.config import load_scene_file as t_load

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")
SCENE_FIELDS = [f.name for f in dataclasses.fields(t_scene.TriangleScene) if f.name != "materials"]
MATERIAL_FIELDS = [f.name for f in dataclasses.fields(MaterialTable)]
CAMERA_FIELDS = ["position", "yaw", "pitch", "world_up", "fov_deg", "near_clip", "far_clip"]


def _assert_field(name, want, got):
    if want is None or got is None:
        assert want is None and got is None, name
        return
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert want.shape == got.shape, name
    if want.dtype.kind == "f":
        # torch and XLA trig and matrix inverse may differ in the last ulp.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_scene_equal(js, ts):
    for name in SCENE_FIELDS:
        _assert_field(name, getattr(js, name), getattr(ts, name))
    for name in MATERIAL_FIELDS:
        _assert_field(name, getattr(js.materials, name), getattr(ts.materials, name))


@pytest.mark.parametrize(
    "config",
    ["config3_icosphere.toml", "config5_invert_target.toml", "config8_icosphere.toml", "config6_icosphere.toml"],
)
def test_config_loads_equal_jax(config):
    path = os.path.join(SCENES, config)
    js, jc, jst = j_load(path)
    ts, tc, tst = t_load(path, device="cpu")
    assert_scene_equal(js, ts)
    for name in CAMERA_FIELDS:
        _assert_field(name, getattr(jc, name), getattr(tc, name))
    assert (tc.width, tc.height) == (jc.width, jc.height)
    for name in ("width", "height", "spp", "bounces", "seed", "jitter", "background",
                 "tri_block", "tri_block_secondary", "estimator", "compact_mode", "sort_rays", "sort_key"):
        assert getattr(tst, name) == getattr(jst, name), name
    # The sort autos resolve alike; only the config 6 stand-in's pack is
    # past the resident budget (decided from row counts, nothing is packed).
    jn, tn = j_narrow(js, jst), t_narrow(ts, tst)
    assert (tn.sort_rays, tn.sort_key) == (jn.sort_rays, jn.sort_key)
    assert (tn.sort_rays, tn.sort_key) == ((True, "origin") if config == "config6_icosphere.toml" else (False, "dir"))


@pytest.mark.parametrize("config", ["config3_icosphere.toml", "config5_invert_target.toml", "config8_icosphere.toml"])
def test_scene_material_set_matches_jax(config):
    """The material types of the live triangles; with no live triangle,
    those of all triangles."""
    path = os.path.join(SCENES, config)
    js, _, _ = j_load(path)
    ts, _, _ = t_load(path, device="cpu")
    assert t_material_set(ts) == j_material_set(js)
    dead_js = js.replace(valid=jnp.zeros_like(js.valid))
    dead_ts = dataclasses.replace(ts, valid=torch.zeros_like(ts.valid))
    assert t_material_set(dead_ts) == j_material_set(dead_js)


def _random_mesh(pkg, rng, n):
    v = rng.normal(size=(n, 3, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3, 3)).astype(np.float32)
    uv = rng.uniform(size=(n, 3, 2)).astype(np.float32)
    return pkg.MeshData(vertices=v, normals=nrm, uvs=uv)


def test_hand_built_specs_equal_jax():
    materials = [
        {"type": "diffuse", "albedo": (0.2, 0.4, 0.6)},
        {"type": "emitter", "emissive_color": (1.0, 0.9, 0.8), "intensity": 4.0},
        {"type": "mirror", "specular_color": (0.9, 0.9, 0.9)},
        {"type": "glass", "refractive_index": 1.33},
    ]

    def specs(pkg, obj_pkg):
        rng = np.random.default_rng(3)
        return [
            pkg.mesh_spec(_random_mesh(obj_pkg, rng, 37), position=(0.5, -1.0, 2.0),
                          rotation_deg=(10.0, 25.0, -40.0), scale=(1.5, 0.5, 2.0), mat_id=0),
            pkg.mesh_spec(_random_mesh(obj_pkg, rng, 11), mat_id=3, two_sided=True),
            pkg.plane_spec((0.0, -2.0, 0.0), (90.0, 0.0, 0.0), (20.0, 20.0, 20.0), mat_id=2),
            pkg.sphere_spec(position=(1.0, 2.0, 3.0), radius=0.7, mat_id=1, subdivisions=2),
        ]

    js = j_scene.build_scene(specs(j_scene, j_obj), materials, pad_to_multiple=64)
    ts = t_scene.build_scene(specs(t_scene, t_obj), materials, pad_to_multiple=64, device="cpu")
    assert ts.num_triangles == js.num_triangles
    assert_scene_equal(js, ts)


def test_stand_in_primary_rays_match_jax():
    path = os.path.join(SCENES, "config3_icosphere.toml")
    _, jc, _ = j_load(path)
    _, tc, _ = t_load(path, device="cpu")
    jc = JCamera.create(position=jc.position, yaw=jc.yaw, pitch=jc.pitch, fov_deg=jc.fov_deg, width=96, height=64)
    tc = dataclasses.replace(tc, width=96, height=64)
    rng = np.random.default_rng(5)
    pixels = np.arange(96 * 64)
    jitter = rng.uniform(size=(pixels.size, 2)).astype(np.float32)
    for jit in (None, jitter):
        jo, jd = j_rays(jc, jnp.asarray(pixels, jnp.uint32), None if jit is None else jnp.asarray(jit))
        to, td = t_rays(tc, torch.as_tensor(pixels), None if jit is None else torch.as_tensor(jit))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-6)


def test_obj_loader_matches_jax(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "f -3 -2 -1\n"
        "f 1//1 2//1 5//1\n"
    )
    want = j_obj.subdivide_mesh(j_obj.load_obj(path), 2)
    got = t_obj.subdivide_mesh(t_obj.load_obj(path), 2)
    for name in ("vertices", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_camera_from_numpy_gives_jax_rays():
    _, jc, _ = j_load(os.path.join(SCENES, "config5_invert_target.toml"))
    tc = interop.camera_from_numpy(interop.numpy_fields(jc, CAMERA_FIELDS), jc.width, jc.height, device="cpu")
    pixels = np.arange(0, jc.width * jc.height, 7)
    jo, jd = j_rays(jc, jnp.asarray(pixels, jnp.uint32))
    to, td = t_rays(tc, torch.as_tensor(pixels))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-6)


def test_reference_scene_specs_match_jax(tmp_path):
    """The reference main()'s scene (its mesh, rocketman.obj, is not in the
    repo: a stand-in OBJ is written under the same name): the same specs
    and materials as the JAX package's."""
    (tmp_path / "rocketman.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1 3 4\n")
    j_specs, j_mats = j_scene.reference_scene(str(tmp_path))
    t_specs, t_mats = t_scene.reference_scene(str(tmp_path))
    assert t_mats == j_mats and len(t_specs) == len(j_specs) == 5
    for js_, ts_ in zip(j_specs, t_specs):
        assert (ts_.mat_id, ts_.two_sided) == (js_.mat_id, js_.two_sided)
        for f in ("vertices", "normals", "uvs", "position", "rotation_deg", "scale"):
            _assert_field(f, getattr(js_, f), getattr(ts_, f))


def test_no_hit_color_matches_jax():
    from gpupathtracer_tpu.models.materials import no_hit_color as j_no_hit
    from gpupathtracer_tpu_torch.models.materials import no_hit_color

    got = no_hit_color(device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_no_hit()))


ANGLES = [0.0, 30.0, 90.0, 180.0, 270.0, -45.5, 123.25, 359.9]


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_mat4_axis_rotations_match_jax(axis):
    """``rotate_{x,y,z}_deg`` against JAX's on a few angles: the sines and
    cosines of two libraries, within one float32 ulp of 1."""
    from gpupathtracer_tpu.core import mat4 as j_mat4
    from gpupathtracer_tpu_torch.core import mat4 as t_mat4

    np.testing.assert_array_equal(t_mat4.identity().numpy(), np.asarray(j_mat4.identity()))
    for deg in ANGLES:
        got = getattr(t_mat4, f"rotate_{axis}_deg")(deg)
        assert got.dtype == torch.float32
        want = np.asarray(getattr(j_mat4, f"rotate_{axis}_deg")(deg))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1.2e-7, err_msg=f"{axis} {deg}")


def test_mat4_trs_composes_the_rotations():
    """``trs`` is T · Rx · Ry · Rz · S of the public helpers, bit for bit,
    and JAX's ``trs`` within one ulp of its entries."""
    from gpupathtracer_tpu.core import mat4 as j_mat4
    from gpupathtracer_tpu_torch.core import mat4 as t_mat4

    rng = np.random.default_rng(11)
    for _ in range(20):
        p, r, s = rng.normal(size=3) * 5, rng.uniform(-360, 360, 3), rng.uniform(0.1, 5, 3)
        got = t_mat4.trs(p, r, s)
        want = (t_mat4.translate(p) @ t_mat4.rotate_x_deg(r[0]) @ t_mat4.rotate_y_deg(r[1])
                @ t_mat4.rotate_z_deg(r[2]) @ t_mat4.scale(s))
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), np.asarray(j_mat4.trs(p, r, s)), rtol=2.4e-7, atol=1e-6)
