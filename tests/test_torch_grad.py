"""Gradients of the port's ``render_frame`` against ``jax.grad`` of the JAX
package's, on the same numpy-seeded scenes: the scene parameters of
``tests/test_grad.py`` (albedo, intensity, per-vertex offsets, light height,
camera position) under the naive, NEE and MIS estimators, and
``resolve_hits`` at its clamps (``tests/test_torch_grad_bench.py`` has the
bench loss). The JAX side runs its Pallas searches in interpret mode, as
``tests/test_torch_render.py`` does.

Tolerance: rtol 1e-4 and atol 1e-6 * max|g| of the JAX gradient. Both
sides take the same hits, so only float32 rounding differs (the order of
the scatter-adds that gather backwards into the scene's rows).

Also, the port alone: central finite differences for albedo and intensity
(rtol 5e-2, as ``tests/test_grad.py``), the contracts of the detached
search (no ``Hit`` or pack requires a gradient, a frame without inputs that
require one records nothing) and the pack cache's refresh after an in-place
edit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_intersect import to_port
from test_torch_render import _resized

from gpupathtracer_tpu.models import camera as j_camera
from gpupathtracer_tpu.models import materials as j_materials
from gpupathtracer_tpu.models import obj as j_obj
from gpupathtracer_tpu.models import scene as j_scene
from gpupathtracer_tpu.ops.intersect import resolve_hits as j_resolve
from gpupathtracer_tpu.render.renderer import RenderSettings as JSettings
from gpupathtracer_tpu.render.renderer import render_frame as j_render
from gpupathtracer_tpu_torch.models import camera as t_camera
from gpupathtracer_tpu_torch.models import materials as t_materials
from gpupathtracer_tpu_torch.models import scene as t_scene
from gpupathtracer_tpu_torch.models.camera import generate_rays
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.ops.intersect import resolve_hits
from gpupathtracer_tpu_torch.render.integrator import IntegratorOptions, make_intersect_fn
from gpupathtracer_tpu_torch.render.renderer import RenderSettings, render_frame
from gpupathtracer_tpu_torch.utils.config import load_scene_file as t_load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
ATOL_OF_MAX = 1e-6


def assert_grad_close(got, want, name):
    """``got`` (a tensor, or None where the input did not reach the loss)
    against the JAX gradient ``want`` within rtol 1e-4, atol 1e-6·max|want|."""
    want = np.asarray(want, np.float32)
    got = np.zeros_like(want) if got is None else got.detach().cpu().numpy()
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_OF_MAX * float(np.abs(want).max()), err_msg=name)


# The scene of tests/test_grad.py: an icosphere under an emitter plane.
SIZE = 12
KW = dict(width=SIZE, height=SIZE, spp=2, bounces=2, tri_block=128, jitter=False)
SPHERE = t_scene.icosphere(1)
MATERIALS = [
    {"type": "diffuse", "albedo": (0.6, 0.6, 0.6)},
    {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 4.0},
]


def _params(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "albedo": np.asarray([0.6, 0.5, 0.4], np.float32),
        "intensity": np.float32(4.0),
        "offsets": (rng.normal(size=SPHERE.vertices.shape) * 0.02).astype(np.float32),
        "light_dy": np.float32(0.1),
        "cam_pos": np.asarray([0.05, -0.1, 4.0], np.float32),
    }


def _jax_loss(estimator):
    settings = JSettings(**KW, estimator=estimator, intersector="pallas")
    base = j_materials.material_table(MATERIALS)

    def loss(p):
        sphere = j_scene.GeometrySpec(
            vertices=jnp.asarray(SPHERE.vertices) + p["offsets"], normals=jnp.asarray(SPHERE.normals),
            uvs=jnp.asarray(SPHERE.uvs), position=jnp.zeros(3), rotation_deg=jnp.zeros(3), scale=jnp.ones(3),
        )
        light = j_scene.plane_spec(jnp.stack([0.0, 3.0 + p["light_dy"], 0.0]), (90.0, 0.0, 0.0), (4.0, 4.0, 4.0), 1)
        mats = base.replace(albedo=base.albedo.at[0].set(p["albedo"]),
                            intensity=base.intensity.at[1].set(p["intensity"]))
        scene = j_scene.build_scene([sphere, light], mats, pad_to_multiple=8)
        cam = j_camera.Camera.create(position=(0.0, 0.0, 4.0), fov_deg=45.0, width=SIZE, height=SIZE)
        return jnp.mean(j_render(scene, cam.replace(position=p["cam_pos"]), settings))

    return loss


def _port_loss(estimator):
    settings = RenderSettings(**KW, estimator=estimator)
    base = t_materials.material_table(MATERIALS, device="cpu")
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)

    def loss(p):
        sphere = t_scene.GeometrySpec(
            vertices=f32(SPHERE.vertices) + p["offsets"], normals=f32(SPHERE.normals), uvs=f32(SPHERE.uvs),
            position=torch.zeros(3), rotation_deg=torch.zeros(3), scale=torch.ones(3),
        )
        light = t_scene.plane_spec(
            torch.stack([torch.tensor(0.0), 3.0 + p["light_dy"], torch.tensor(0.0)]), (90.0, 0.0, 0.0),
            (4.0, 4.0, 4.0), 1,
        )
        mats = dataclasses.replace(
            base, albedo=torch.cat([p["albedo"][None], base.albedo[1:]]),
            intensity=torch.cat([base.intensity[:1], p["intensity"][None]]),
        )
        scene = t_scene.build_scene([sphere, light], mats, pad_to_multiple=8, device="cpu")
        cam = t_camera.Camera.create(position=(0.0, 0.0, 4.0), fov_deg=45.0, width=SIZE, height=SIZE, device="cpu")
        return render_frame(scene, dataclasses.replace(cam, position=p["cam_pos"]), settings, device="cpu").mean()

    return loss


def _leaves(params):
    return {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}


@pytest.mark.parametrize("estimator", ["naive", "nee", "mis"])
def test_scene_parameter_gradients_match_jax(estimator):
    """d mean(image) / d(albedo, intensity, per-vertex offsets, light
    height, camera position), every one in one loss."""
    params = _params()
    want_loss, want = jax.value_and_grad(_jax_loss(estimator))({k: jnp.asarray(v) for k, v in params.items()})
    p = _leaves(params)
    loss = _port_loss(estimator)(p)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    for name in params:
        assert_grad_close(p[name].grad, want[name], name)
    assert float(np.abs(np.asarray(want["albedo"])).max()) > 0
    if estimator != "naive":  # naive paths are products of constants: no geometry gradient
        assert float(np.abs(np.asarray(want["offsets"])).max()) > 0


def _central_fd(f, x0, eps):
    return (f(x0 + eps) - f(x0 - eps)) / (2 * eps)


@pytest.mark.parametrize("name,x0", [("albedo", 0.6), ("intensity", 4.0)])
def test_gradient_matches_finite_differences(name, x0):
    """The port alone: the NEE estimator's gradient in albedo (first
    channel) and intensity against central differences (rtol 5e-2, as
    tests/test_grad.py)."""
    params = _params()
    loss_fn = _port_loss("nee")

    def loss_at(x):
        p = {k: torch.tensor(v) for k, v in params.items()}
        p[name] = torch.cat([torch.tensor([x]), p[name][1:]]) if name == "albedo" else torch.tensor(x)
        return loss_fn(p)

    x = torch.tensor(x0, requires_grad=True)
    p = {k: torch.tensor(v) for k, v in params.items()}
    p[name] = torch.cat([x[None], p[name][1:]]) if name == "albedo" else x
    (g,) = torch.autograd.grad(loss_fn(p), x)
    with torch.no_grad():
        fd = _central_fd(lambda v: loss_at(v).item(), x0, 1e-2)
    assert g.item() > 0
    np.testing.assert_allclose(g.item(), fd, rtol=5e-2)


def test_search_and_packs_carry_no_gradient():
    """The hit record and the packs never require a gradient while the
    image does, and a frame with no input that requires one records
    nothing."""
    (_, _, _), (ts_, tc, tst) = _resized("config5_invert_target.toml", 8, 1)
    v0 = ts_.v0.clone().requires_grad_()
    scene = dataclasses.replace(ts_, v0=v0)
    opts = IntegratorOptions(bounces=1, material_set=(0, 1))
    o, d = generate_rays(tc)
    o = o + 0.0 * v0[:1]  # rays that carry a gradient
    assert o.requires_grad
    hit = make_intersect_fn(scene, opts)(o, d)
    assert not (hit.t.requires_grad or hit.tri.requires_grad or hit.hit.requires_grad)
    occ = tpi.intersect_packed_occluded(o, d, torch.full((o.shape[0],), 5.0, requires_grad=True),
                                        tpi.pack_scene(scene, tri_block=128))
    assert not occ.requires_grad
    packed = tpi.pack_scene(scene, tri_block=128)
    assert not any(getattr(packed, f.name).requires_grad for f in dataclasses.fields(packed)
                   if isinstance(getattr(packed, f.name), torch.Tensor))
    img = render_frame(scene, tc, dataclasses.replace(tst, estimator="nee"), device="cpu")
    assert img.requires_grad
    plain = render_frame(ts_, tc, tst, device="cpu")
    assert not plain.requires_grad and plain.grad_fn is None
    assert torch.equal(plain, render_frame(scene, tc, tst, device="cpu").detach())


def _config5(size=16):
    scene, camera, settings = t_load(os.path.join(ROOT, "scenes", "config5_invert_target.toml"), device="cpu")
    camera = dataclasses.replace(camera, width=size, height=size)
    return scene, camera, dataclasses.replace(settings, width=size, height=size, spp=1)


def test_pack_refreshes_after_an_in_place_edit():
    """An in-place edit of v0 under no_grad, then a render, equals a render
    on a fresh pack, and differs from the render before the edit."""
    scene, camera, settings = _config5()
    before = render_frame(scene, camera, settings, device="cpu")
    with torch.no_grad():
        scene.v0.add_(0.3)
    after = render_frame(scene, camera, settings, device="cpu")
    tpi._PACK_CACHE.clear()
    fresh = render_frame(scene, camera, settings, device="cpu")
    assert torch.equal(after, fresh)
    assert not torch.equal(after, before)
    assert (after - before).abs().mean().item() > 1e-2


def test_pack_refreshes_after_an_optimizer_step():
    """A leaf v0 that requires a gradient, stepped by torch.optim: the next
    frame packs the stepped geometry."""
    scene, camera, settings = _config5()
    v0 = torch.nn.Parameter(scene.v0.clone())
    scene = dataclasses.replace(scene, v0=v0)
    opt = torch.optim.SGD([v0], lr=1.0)
    img = render_frame(scene, camera, dataclasses.replace(settings, estimator="nee"), device="cpu")
    img.mean().backward()
    packed = tpi.pack_scene(scene, tri_block=settings.tri_block)
    with torch.no_grad():
        v0.grad.fill_(-0.3)  # a step large enough to move the hits
    opt.step()
    assert tpi.pack_scene(scene, tri_block=settings.tri_block) is not packed
    after = render_frame(scene, camera, settings, device="cpu")
    tpi._PACK_CACHE.clear()
    assert torch.equal(after, render_frame(scene, camera, settings, device="cpu"))


def test_grad_render_equals_forward_render():
    """A frame with inputs that require a gradient has the forward-only
    frame's image, bit for bit."""
    (_, _, _), (ts_, tc, tst) = _resized("config5_invert_target.toml", 16, 2)
    tst = dataclasses.replace(tst, estimator="nee")
    v0 = ts_.v0.clone().requires_grad_()
    img = render_frame(dataclasses.replace(ts_, v0=v0), tc, tst, device="cpu")
    assert torch.equal(img.detach(), render_frame(ts_, tc, tst, device="cpu"))


def test_resolve_hits_gradient_at_the_clamps_matches_jax():
    """``resolve_hits`` where t lands exactly on its clip bound 1e8 (the JAX
    package's jnp.clip passes half the gradient there, torch.clamp all of
    it), beyond it (no gradient), inside it, and for a missed ray (index -1
    gathers row 0): the gradients in rays and geometry equal JAX's."""
    tris = np.asarray(
        [[[-1.0, -1.0, z], [1.0, -1.0, z], [-1.0, 1.0, z]] for z in (-1e8, -2e8, -3.0)], np.float32
    )
    mesh = j_obj.MeshData(vertices=tris, normals=np.tile(np.float32([0.0, 0.0, 1.0]), (3, 3, 1)),
                          uvs=np.zeros((3, 3, 2), np.float32))
    js = j_scene.build_scene([j_scene.mesh_spec(mesh)], [{"type": "diffuse"}], pad_to_multiple=4)
    ts_ = to_port(js)
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (4, 1))
    tri = np.asarray([0, 1, 2, -1])

    weights = np.random.default_rng(5).normal(size=(4, 1 + 3 + 3 + 3 + 2 + 2)).astype(np.float32)

    def summed(a):
        # A weighted sum, so that no two outputs' gradients cancel.
        parts = [a.t[:, None], a.point, a.gn, a.sn, a.uv, a.bary]
        cat = torch.cat(parts, dim=1) if isinstance(a.t, torch.Tensor) else jnp.concatenate(parts, axis=1)
        return (cat * (torch.as_tensor(weights) if isinstance(a.t, torch.Tensor) else weights)).sum()

    def j_loss(o, d, v0, e1, e2):
        return summed(j_resolve(o, d, js.replace(v0=v0, e1=e1, e2=e2), jnp.asarray(tri, jnp.int32)))

    names = ("o", "d", "v0", "e1", "e2")
    want = jax.grad(j_loss, argnums=tuple(range(5)))(jnp.asarray(o), jnp.asarray(d), js.v0, js.e1, js.e2)
    leaves = [torch.tensor(np.asarray(x), requires_grad=True) for x in (o, d, js.v0, js.e1, js.e2)]
    scene = dataclasses.replace(ts_, v0=leaves[2], e1=leaves[3], e2=leaves[4])
    attrs = resolve_hits(leaves[0], leaves[1], scene, torch.as_tensor(tri))
    assert attrs.t[:3].tolist() == [1e8, 1e8, 3.0]
    summed(attrs).backward()
    for leaf, w, name in zip(leaves, want, names):
        assert_grad_close(leaf.grad, w, name)
