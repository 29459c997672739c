"""The port's shadow-silhouette boundary term (``shadow_edge_gradient``)
against the JAX package's, on one numpy-built scene that holds every path
the term walks: a grey floor and wall lit by an emitter, a black occluder
between them (its scale ``s`` is the parameter), a mirror and a glass pane
that the camera sees parts of the floor through. The cases: the flat edge
picker over every edge, the specular prefix through the mirror and the
glass, the hierarchical picker (clusters of 4 edges passed in), the second diffuse
vertex (the wall, reached by scattering from the floor), the camera term
(``camera_fn`` in dx and yaw) and ``value_and_grad_with_edges`` with the
shadow term. Tolerance: rtol 1e-3 and atol 1e-6 * max|g| of the JAX
gradient (``tests/test_torch_edges.py`` says why). The JAX side uses its
brute intersector, as its own shadow tests do; each JAX reference is
computed once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_edges import QUAD, _build, _spec, assert_grad_close

from gpupathtracer_tpu.grad import edges as je
from gpupathtracer_tpu.models import camera as jcam
from gpupathtracer_tpu.models import scene as jsn
from gpupathtracer_tpu.render.renderer import RenderSettings as JSettings
from gpupathtracer_tpu_torch.grad import edges as te
from gpupathtracer_tpu_torch.models import camera as tcam
from gpupathtracer_tpu_torch.models import scene as tsn
from gpupathtracer_tpu_torch.ops import threefry
from gpupathtracer_tpu_torch.render.renderer import RenderSettings

SIZE = 24
SAMPLES = 256
MATERIALS = [
    {"type": "diffuse", "albedo": (0.6, 0.6, 0.6)},
    {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 6.0},
    {"type": "diffuse", "albedo": (0.0, 0.0, 0.0)},
    {"type": "mirror", "specular_color": (0.9, 0.9, 0.9)},
    {"type": "glass", "refractive_index": 1.5, "transmittance_color": (0.95, 0.97, 1.0)},
]
KW = dict(width=SIZE, height=SIZE, spp=4, bounces=2, tri_block=8, estimator="nee", intersector="brute", jitter=True)
CAM_KW = dict(position=(0.0, 1.0, 4.5), pitch=-25.0, fov_deg=50.0, width=SIZE, height=SIZE)
PARAMS = {"s": 1.0, "dx": 0.0, "yaw": 0.0}


def scene(mod, xp, p):
    """Floor (y = 0) and wall (x = -1) under a light (y = 3), the black
    occluder (y = 1.5, scaled by p["s"]) between, a mirror on the right
    and a glass pane before the camera."""
    occ = _spec(mod, xp, xp.asarray(QUAD) * p["s"], position=(0.0, 1.5, 0.0), rotation=(90.0, 0.0, 0.0), mat_id=2,
                two_sided=True)
    specs = [
        mod.plane_spec((0.0, 0.0, 0.0), (90.0, 0.0, 0.0), (6.0, 6.0, 6.0), mat_id=0),
        mod.plane_spec((-1.0, 1.5, 0.0), (0.0, 90.0, 0.0), (6.0, 3.0, 1.0), mat_id=0),
        mod.plane_spec((0.0, 3.0, 0.0), (90.0, 0.0, 0.0), (1.5, 1.5, 1.5), mat_id=1),
        occ,
        mod.plane_spec((1.8, 1.0, -0.5), (0.0, -40.0, 0.0), (2.0, 2.0, 1.0), mat_id=3),
        mod.plane_spec((-0.6, 0.5, 2.2), (0.0, 0.0, 0.0), (1.2, 1.2, 1.0), mat_id=4),
    ]
    return _build(mod, specs, MATERIALS, 8)


def _camera_fn(cam, xp, replace):
    return lambda p: replace(cam, position=cam.position + xp.asarray([1.0, 0.0, 0.0]) * p["dx"], yaw=cam.yaw + p["yaw"])


def _cot():
    return np.random.default_rng(3).normal(size=(SIZE, SIZE, 3)).astype(np.float32)


# "occluder_edges" keeps the occluder's edges only, as tests/test_edges.py's
# second-vertex FD test does: static edges add no gradient, and the few
# receivers behind the mirror and the glass or on the wall then pick the
# occluder's (with every edge, their picks land on the light's).
CASES = {
    "flat, every edge": {},
    "mirror and glass prefix": {"occluder_edges": True},
    "hierarchical": {"clusters": 4},
    "second diffuse vertex": {"diffuse_depth": 2, "occluder_edges": True},
    "camera_fn dx and yaw": {"camera_fn": True},
}


def _jax_side():
    cam = jcam.Camera.create(**CAM_KW)
    fn = lambda p: scene(jsn, jnp, p)
    p = {k: jnp.float32(v) for k, v in PARAMS.items()}
    return fn, p, cam, JSettings(**KW), je.build_edge_table(fn(p), native=False)


def _port_side():
    cam = tcam.Camera.create(**CAM_KW, device="cpu")
    fn = lambda p: scene(tsn, torch, p)
    p = {k: torch.tensor(v) for k, v in PARAMS.items()}
    return fn, p, cam, RenderSettings(**KW), te.build_edge_table(fn(p))


def _occluder_edges(table, scene_):
    occ = np.asarray(scene_.geom_id)[table.tri1] == 3
    return dataclasses.replace(table, tri1=table.tri1[occ], corner=table.corner[occ], tri2=table.tri2[occ],
                               two_sided=table.two_sided[occ])


def _options(case, edges, fn, p, cam, replace, xp, table):
    """The case's keyword arguments and edge table."""
    kw = dict(CASES[case])
    if kw.pop("occluder_edges", False):
        table = _occluder_edges(table, fn(p))
    if "clusters" in kw:
        kw["clusters"] = edges.build_edge_clusters(fn(p), edges.build_edge_table(fn(p), **(
            {"native": False} if edges is je else {})), cluster_size=kw["clusters"])
    if kw.pop("camera_fn", False):
        kw["camera_fn"] = _camera_fn(cam, xp, replace)
    return kw, table


@pytest.fixture(scope="module")
def jax_refs():
    fn, p, cam, st, table = _jax_side()
    cot = jnp.asarray(_cot())
    refs = {}
    for case in CASES:
        kw, t = _options(case, je, fn, p, cam, lambda c, **k: c.replace(**k), jnp, table)
        refs[case] = je.shadow_edge_gradient(fn, p, cam, st, cot, t, jax.random.PRNGKey(13), n_samples=SAMPLES, **kw)
    refs["composed"] = je.value_and_grad_with_edges(
        jnp.mean, fn, p, cam, st, table, jax.random.PRNGKey(21), n_samples=SAMPLES, trace_spp=1, shadow_edges=True,
        shadow_samples=SAMPLES, shadow_diffuse_depth=2, camera_fn=_camera_fn(cam, jnp, lambda c, **k: c.replace(**k)),
    )
    return refs


def _port_gradient(case, **extra):
    fn, p, cam, st, table = _port_side()
    kw, table = _options(case, te, fn, p, cam, dataclasses.replace, torch, table)
    return te.shadow_edge_gradient(fn, p, cam, st, torch.as_tensor(_cot()), table, threefry.PRNGKey(13),
                                   n_samples=SAMPLES, device="cpu", **{**kw, **extra})


@pytest.mark.parametrize("case", list(CASES))
def test_shadow_edge_gradient_matches_jax(jax_refs, case):
    got, want = _port_gradient(case), jax_refs[case]
    assert abs(float(want["s"])) > 0
    for k in PARAMS:
        assert_grad_close(got[k], want[k], f"{case}: {k}")
    if case == "camera_fn dx and yaw":
        assert abs(float(want["dx"])) > 0 and abs(float(want["yaw"])) > 0


def test_value_and_grad_with_edges_with_shadows_matches_jax(jax_refs):
    """Interior + primary + shadow terms (second diffuse vertex, camera_fn)."""
    fn, p, cam, st, table = _port_side()
    loss, got = te.value_and_grad_with_edges(
        torch.mean, fn, p, cam, st, table, threefry.PRNGKey(21), n_samples=SAMPLES, trace_spp=1, shadow_edges=True,
        shadow_samples=SAMPLES, shadow_diffuse_depth=2, camera_fn=_camera_fn(cam, torch, dataclasses.replace),
        device="cpu",
    )
    want_loss, want = jax_refs["composed"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    for k in PARAMS:
        assert_grad_close(got[k], want[k], k)


def test_each_path_carries_signal():
    """The scene exercises what the cases claim: the specular prefix and the
    second diffuse vertex change the estimate (the receivers they add, four
    behind the glass and one in the mirror, and those on the wall, see the
    occluder's shadow)."""
    assert _port_gradient("mirror and glass prefix")["s"] != _port_gradient("mirror and glass prefix", specular_depth=1)["s"]
    assert _port_gradient("second diffuse vertex")["s"] != _port_gradient("second diffuse vertex", diffuse_depth=1)["s"]
