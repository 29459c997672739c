"""The port's render path against the JAX package's ``render_frame``, plus the
port's contracts: the any-hit search runs only where the JAX package runs
its kernel, the BVH intersector (outside the port so far) raises, entry
points default to the card and a missing GPU raises, and the port imports
no JAX."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.models.camera import Camera as JCamera
from gpupathtracer_tpu.render.integrator import IntegratorOptions as JOptions
from gpupathtracer_tpu.render.integrator import trace_paths as j_trace
from gpupathtracer_tpu.render.renderer import render_frame as j_render
from gpupathtracer_tpu.utils.config import load_scene_file as j_load
from gpupathtracer_tpu_torch import interop
from gpupathtracer_tpu_torch.models.camera import Camera as TCamera
from gpupathtracer_tpu_torch.models.materials import material_table
from gpupathtracer_tpu_torch.models.scene import build_scene, sphere_spec
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.ops import sampling as ts
from gpupathtracer_tpu_torch.ops.packed_intersect import pack_scene
from gpupathtracer_tpu_torch.render.film import Film, to_u8
from gpupathtracer_tpu_torch.render.integrator import IntegratorOptions, make_bounce_fn, make_intersect_fn, trace_paths
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils.config import load_scene_file as t_load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "scenes")


def assert_image_bar(got, want):
    """The image parity bar (tests_tpu/test_onchip.py)."""
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff.max(axis=-1) > 3e-2).mean() < 5e-3


def _resized(config, size, spp):
    path = os.path.join(SCENES, config)
    js, jc, jst = j_load(path)
    ts_, tc, tst = t_load(path, device="cpu")
    jc = JCamera.create(position=jc.position, yaw=jc.yaw, pitch=jc.pitch, fov_deg=jc.fov_deg, width=size, height=size)
    tc = dataclasses.replace(tc, width=size, height=size)
    jst = dataclasses.replace(jst, width=size, height=size, spp=spp, intersector="pallas")
    tst = dataclasses.replace(tst, width=size, height=size, spp=spp)
    return (js, jc, jst), (ts_, tc, tst)


@pytest.mark.parametrize(
    "config,size,spp,change",
    [
        ("config3_icosphere.toml", 48, 2, {}),
        ("config5_invert_target.toml", 32, 2, {}),
        # The remaining render options of the naive path, away from their defaults.
        ("config5_invert_target.toml", 24, 2,
         {"use_shading_normals": True, "background": (0.1, 0.2, 0.3), "jitter": False, "bounces": 3}),
        # NEE and MIS with textures; two packs, so the scan bounces' shadow
        # rays take the any-hit search.
        ("config8_icosphere.toml", 32, 2, {}),
        ("config8_icosphere.toml", 32, 2, {"estimator": "mis"}),
        # NEE with one pack: every bounce thresholds the closest hit.
        ("config5_invert_target.toml", 16, 2, {"estimator": "nee"}),
        ("config5_invert_target.toml", 16, 2, {"estimator": "mis", "use_shading_normals": True}),
    ],
)
def test_render_matches_jax(config, size, spp, change, record_property):
    (js, jc, jst), (ts_, tc, tst) = _resized(config, size, spp)
    jst, tst = dataclasses.replace(jst, **change), dataclasses.replace(tst, **change)
    want = np.asarray(j_render(js, jc, jst))
    got = render_frame(ts_, tc, tst, device="cpu").numpy()
    assert got.shape == want.shape and want.mean() > 0.05
    record_property("max_abs_diff", float(np.abs(got - want).max()))
    assert_image_bar(got, want)


def test_trace_paths_matches_jax_without_compaction():
    """trace_paths with one pack and compaction off, on the same rays and keys."""
    (js, jc, _), (ts_, tc, _) = _resized("config5_invert_target.toml", 24, 1)
    from gpupathtracer_tpu.models.camera import generate_rays
    from gpupathtracer_tpu.ops import sampling as js_sampling
    from gpupathtracer_tpu_torch.models.camera import generate_rays as t_generate_rays

    o, d = generate_rays(jc)
    ids = jnp.arange(o.shape[0], dtype=jnp.uint32)
    opts = JOptions(bounces=3, intersector="pallas", compact=False)
    want = np.asarray(jax.jit(lambda o, d, k: j_trace(js, o, d, k, opts))(o, d, js_sampling.path_keys(7, ids)))
    to, td = t_generate_rays(tc)
    keys = ts.path_keys(7, torch.arange(to.shape[0]))
    got = trace_paths(ts_, to, td, keys, IntegratorOptions(bounces=3, compact=False, material_set=(0, 1)))
    assert_image_bar(got.numpy()[None], want[None])


def test_render_on_missing_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    (_, _, _), (ts_, tc, tst) = _resized("config5_invert_target.toml", 8, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_frame(ts_, tc, tst, device="cuda")


def _counting(monkeypatch, name, plain):
    """Replace ``packed_intersect.<name>`` by a stub that counts its calls
    and runs the plain version."""
    def stub(*args):
        stub.calls += 1
        return plain(*args)

    stub.calls = 0
    monkeypatch.setattr(tpi, name, stub)
    return stub


@pytest.mark.parametrize(
    "change,closest,anyhit",
    [
        ({}, 4, 2),  # bounce 0: closest + thresholded shadow rays; scan bounces: closest + any hit
        ({"tri_block_secondary": None}, 6, 0),  # one pack: thresholded closest hit on every bounce
        ({"bounces": 1}, 2, 0),
        ({"estimator": "naive"}, 3, 0),
    ],
)
def test_any_hit_search_runs_only_on_secondary_pack_bounces(monkeypatch, change, closest, anyhit):
    """Per sample, as the JAX package's render_frame: shadow rays take the
    any-hit search only on the scan bounces built from the second pack."""
    (_, _, _), (ts_, tc, tst) = _resized("config8_icosphere.toml", 16, 1)
    ch = _counting(monkeypatch, "closest_hit", tpi.closest_hit_reference)
    oc = _counting(monkeypatch, "occluded", tpi.occluded_reference)
    img = render_frame(ts_, tc, dataclasses.replace(tst, **change), device="cpu")
    assert torch.isfinite(img).all()
    assert (ch.calls, oc.calls) == (closest, anyhit)


def test_custom_intersector_keeps_the_threshold_path(monkeypatch):
    (_, _, _), (ts_, tc, tst) = _resized("config8_icosphere.toml", 16, 1)
    opts = IntegratorOptions(bounces=3, estimator="nee", material_set=(0, 1), textured=True)
    ch = _counting(monkeypatch, "closest_hit", tpi.closest_hit_reference)
    oc = _counting(monkeypatch, "occluded", tpi.occluded_reference)
    custom = make_intersect_fn(ts_, opts)
    from gpupathtracer_tpu_torch.models.camera import generate_rays

    o, d = generate_rays(tc)
    trace_paths(ts_, o, d, ts.path_keys(0, torch.arange(o.shape[0])), opts, intersect_fn=custom)
    assert (ch.calls, oc.calls) == (6, 0)
    with pytest.raises(ValueError, match="custom intersect_fn"):
        make_bounce_fn(ts_, opts, intersect_fn=custom, occlusion_kernel=True)


@pytest.mark.parametrize(
    "entry",
    [
        lambda: t_load(os.path.join(SCENES, "config8_icosphere.toml")),
        lambda: build_scene([sphere_spec()], [{"type": "diffuse"}]),
        lambda: material_table([{"type": "diffuse"}]),
        lambda: TCamera.create(),
        lambda: Film.zeros(2, 2),
        lambda: render_frame(*_resized("config5_invert_target.toml", 8, 1)[1]),
        lambda: interop.camera_from_numpy(
            {k: np.zeros(3 if k in ("position", "world_up") else (), np.float32)
             for k in ("position", "yaw", "pitch", "world_up", "fov_deg", "near_clip", "far_clip")}, 4, 4),
    ],
    ids=["load_scene_file", "build_scene", "material_table", "Camera.create", "Film.zeros", "render_frame",
         "camera_from_numpy"],
)
def test_entry_points_default_to_the_card(entry):
    """With no ``device`` the entry points ask for the card; without one they
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def _render_with(change):
    (_, _, _), (ts_, tc, tst) = _resized("config5_invert_target.toml", 8, 1)
    return render_frame(ts_, tc, dataclasses.replace(tst, **change), device="cpu")


@pytest.mark.parametrize("call", [lambda: _render_with({"intersector": "bvh"})], ids=["bvh"])
def test_options_outside_the_slice_raise(call):
    with pytest.raises(NotImplementedError):
        call()


def test_unknown_sort_key_raises():
    (_, _, _), (ts_, tc, tst) = _resized("config5_invert_target.toml", 8, 1)
    with pytest.raises(ValueError, match="sort key"):
        render_frame(ts_, tc, dataclasses.replace(tst, sort_rays=True, sort_key="octant"), device="cpu")


def _many_lights_scenes():
    """A floor and a sphere under 1,200 random emitter triangles of areas
    spread over three decades, built in both packages from the same specs."""
    from gpupathtracer_tpu.models import obj as j_obj
    from gpupathtracer_tpu.models import scene as j_scene
    from gpupathtracer_tpu_torch.models import obj as t_obj
    from gpupathtracer_tpu_torch.models import scene as t_scene

    rng = np.random.default_rng(21)
    n = 1200
    centers = np.stack([rng.uniform(-3, 3, n), rng.uniform(3.0, 4.0, n), rng.uniform(-3, 3, n)], axis=1)
    size = 10.0 ** rng.uniform(-2.0, -0.5, n)
    tris = (centers[:, None, :] + rng.normal(size=(n, 3, 3)) * size[:, None, None]).astype(np.float32)
    materials = [{"type": "diffuse", "albedo": (0.7, 0.6, 0.5)},
                 {"type": "emitter", "emissive_color": (1.0, 0.9, 0.8), "intensity": 5.0}]

    def specs(pkg, obj_pkg):
        mesh = obj_pkg.MeshData(vertices=tris, normals=np.zeros_like(tris), uvs=np.zeros((n, 3, 2), np.float32))
        return [pkg.plane_spec((0.0, -1.0, 0.0), (90.0, 0.0, 0.0), (20.0, 20.0, 20.0)),
                pkg.sphere_spec(radius=1.0, subdivisions=2),
                pkg.mesh_spec(mesh, mat_id=1, two_sided=True)]

    js = j_scene.build_scene(specs(j_scene, j_obj), materials, pad_to_multiple=128)
    ts = t_scene.build_scene(specs(t_scene, t_obj), materials, pad_to_multiple=128, device="cpu")
    return js, ts


def test_many_light_cdf_and_nee_render_match_jax():
    """With 1,200 emitters the float64-summed light CDF agrees with the JAX
    package's float32 cumsum to rtol 1e-6, and the NEE render meets the
    image bar."""
    from gpupathtracer_tpu.models.materials import BxdfType
    from gpupathtracer_tpu.render.renderer import RenderSettings as JSettings
    from gpupathtracer_tpu_torch.render.integrator import light_table
    from gpupathtracer_tpu_torch.render.renderer import RenderSettings

    js, ts = _many_lights_scenes()
    cdf, total = light_table(ts)
    tri_area = 0.5 * jnp.linalg.norm(jnp.cross(js.e1, js.e2), axis=-1)
    light_w = tri_area * ((js.materials.type[js.mat_id] == BxdfType.EMITTER) & js.valid).astype(jnp.float32)
    np.testing.assert_allclose(cdf.numpy(), np.asarray(jnp.cumsum(light_w)), rtol=1e-6, atol=0)
    np.testing.assert_allclose(total.item(), float(jnp.sum(light_w)), rtol=1e-6)
    assert int((np.asarray(light_w) > 0).sum()) >= 1000

    kw = dict(width=16, height=16, spp=2, bounces=2, estimator="nee", tri_block=256)
    jc = JCamera.create(position=(0.0, 1.0, 8.0), fov_deg=50.0, width=16, height=16)
    tc = TCamera.create(position=(0.0, 1.0, 8.0), fov_deg=50.0, width=16, height=16, device="cpu")
    want = np.asarray(j_render(js, jc, JSettings(**kw, intersector="pallas")))
    got = render_frame(ts, tc, RenderSettings(**kw), device="cpu").numpy()
    assert want.mean() > 0.01
    assert_image_bar(got, want)


def test_packed_secondary_with_custom_intersector_raises():
    (_, _, _), (ts_, tc, tst) = _resized("config5_invert_target.toml", 8, 1)
    opts = IntegratorOptions(bounces=2, material_set=(0, 1))
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    custom = make_intersect_fn(ts_, opts)
    with pytest.raises(ValueError, match="packed_secondary"):
        trace_paths(ts_, o, d, ts.path_keys(0, torch.arange(4)), opts, intersect_fn=custom,
                    packed_secondary=pack_scene(ts_, tri_block=64))


def test_film_accumulates_and_converts():
    film = Film.zeros(2, 3, device="cpu")
    film = film.add_samples(torch.full((2, 3, 3), 0.5)).add_samples(torch.full((2, 3, 3), 1.5))
    assert torch.allclose(film.to_image(), torch.ones((2, 3, 3)))
    u8 = to_u8(film.to_image() * 2.0)
    assert u8.dtype == np.uint8 and (u8 == 255).all()


def test_port_imports_no_jax():
    """Every module of the port, the trainer and its checkpoints among them,
    imports with jax, flax and optax made unimportable, and imports nothing
    of the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['optax'] = None\n"
        "import gpupathtracer_tpu_torch.grad.inverse, gpupathtracer_tpu_torch.utils.checkpoint\n"
        "import gpupathtracer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = ('jax', 'optax', 'gpupathtracer_tpu')\n"
        "assert not any(k.split('.')[0] in bad for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
