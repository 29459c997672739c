"""The port's BVH (``accel/bvh.py``) and the ``bvh`` route of
``render_frame`` against the JAX package: the builder's arrays equal JAX's
element for element, the structure holds, ``intersect_bvh`` gives JAX's
(t, tri) exactly on the same BVH and meets the hit bar against the brute
oracle, and a ``bvh`` frame is within the image bar of JAX's."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.accel import bvh as jbvh
from gpupathtracer_tpu.models.camera import Camera as JCamera
from gpupathtracer_tpu.models.obj import MeshData
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.render.renderer import render_frame as j_render
from gpupathtracer_tpu.render.renderer import render_samples as j_render_samples
from gpupathtracer_tpu.utils.config import load_scene_file as j_load
from gpupathtracer_tpu_torch import interop
from gpupathtracer_tpu_torch.accel import bvh as tbvh
from gpupathtracer_tpu_torch.models.materials import MaterialTable
from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops.intersect import intersect_brute
from gpupathtracer_tpu_torch.render import renderer as trenderer
from gpupathtracer_tpu_torch.render.renderer import render_frame, render_samples
from gpupathtracer_tpu_torch.utils.config import load_scene_file as t_load

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")
FIELDS = ("box_lo", "box_hi", "first", "count", "miss", "tri_order")


def to_port(js) -> TriangleScene:
    fields = interop.numpy_fields(js, [f.name for f in dataclasses.fields(TriangleScene) if f.name != "materials"])
    fields["materials"] = interop.numpy_fields(js.materials, [f.name for f in dataclasses.fields(MaterialTable)])
    return interop.scene_from_numpy(fields, device="cpu")


def random_scene(seed=0, n=300, rays=500):
    """Random one-sided and two-sided triangles and a plane (as the JAX
    package's tests/test_bvh.py builds them), with random rays."""
    rng = np.random.default_rng(seed)

    def mk(k):
        t = rng.normal(size=(k, 3, 3)).astype(np.float32) * 2
        return MeshData(vertices=t, normals=np.zeros((k, 3, 3), np.float32), uvs=np.zeros((k, 3, 2), np.float32))

    js = build_scene(
        [mesh_spec(mk(n)), mesh_spec(mk(40), two_sided=True), plane_spec((0, 0, 0), (15, 25, 0), (3, 3, 3))],
        [{"type": "diffuse"}],
        pad_to_multiple=128,
    )
    o = (rng.normal(size=(rays, 3)) * 4).astype(np.float32)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return js, o, d


@pytest.mark.parametrize("leaf_size", [4, 8, 16])
def test_build_bvh_equals_jax(leaf_size):
    js, _, _ = random_scene(seed=leaf_size)
    want = jbvh.build_bvh(js, leaf_size=leaf_size)
    got = tbvh.build_bvh(to_port(js), leaf_size=leaf_size)
    assert got.leaf_size == want.leaf_size and got.num_nodes == want.num_nodes
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == (np.float32 if f.startswith("box") else np.int64), f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _reachable_once(bvh, scene):
    order = bvh.tri_order.numpy()
    assert sorted(order[order >= 0].tolist()) == np.where(scene.valid.numpy())[0].tolist()


def _leaf_spans_tile(bvh, scene):
    leaves = bvh.count > 0
    spans = sorted(zip(bvh.first[leaves].tolist(), (bvh.first + bvh.count)[leaves].tolist()))
    pos = 0
    for a, b in spans:
        assert a == pos
        pos = b
    assert pos == int((bvh.tri_order >= 0).sum())


def _escape_links_monotone(bvh, scene):
    m = bvh.num_nodes
    assert bool((bvh.miss > torch.arange(m)).all()) and bool((bvh.miss <= m).all())


@pytest.mark.parametrize("check,seed,leaf_size", [(_reachable_once, 0, 8), (_leaf_spans_tile, 1, 4),
                                                  (_escape_links_monotone, 2, 8)],
                         ids=["reachable_once", "leaf_spans_tile", "escape_links_monotone"])
def test_bvh_structure(check, seed, leaf_size):
    js, _, _ = random_scene(seed=seed)
    scene = to_port(js)
    check(tbvh.build_bvh(scene, leaf_size=leaf_size), scene)


def test_intersect_bvh_equals_jax_and_meets_the_oracle():
    """The same hits and winning rows as JAX's traversal on the same BVH,
    exactly (the same slab test, visiting order and tie rule), with t to
    the hit bar's rtol = atol = 1e-5: XLA's CPU backend contracts the
    jitted traversal's cross and dot products into FMAs, torch's CPU only
    the cross products (``tools/bvh_t_check.py``), so t differs in the last
    bits on some lanes. Then the hit bar against the brute oracle (ties may
    resolve in traversal order there)."""
    js, o, d = random_scene(seed=3)
    jb = jbvh.build_bvh(js, leaf_size=8)
    want = jbvh.intersect_bvh(jnp.asarray(o), jnp.asarray(d), js, jb)
    scene = to_port(js)
    got = tbvh.intersect_bvh(torch.as_tensor(o), torch.as_tensor(d), scene, tbvh.build_bvh(scene, leaf_size=8))
    assert 0.2 < got.hit.double().mean() < 1.0
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5, atol=1e-5)  # the hit bar's t
    oracle = intersect_brute(torch.as_tensor(o), torch.as_tensor(d), scene, tri_block=128)
    assert torch.equal(got.hit, oracle.hit)
    h = oracle.hit
    np.testing.assert_allclose(got.t[h].numpy(), oracle.t[h].numpy(), rtol=1e-5, atol=1e-5)
    assert (got.tri == oracle.tri)[h].double().mean() > 0.9995


def test_intersect_bvh_two_sided_plane():
    scene = to_port(build_scene([plane_spec((0, 0, 0), (0, 0, 0), (5, 5, 5))], [{"type": "diffuse"}],
                                pad_to_multiple=8))
    o = torch.tensor([[0.0, 0.0, 5.0], [0.0, 0.0, -5.0], [2.6, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    h = tbvh.intersect_bvh(o, d, scene, tbvh.build_bvh(scene, leaf_size=4))
    assert h.hit.tolist() == [True, True, False]
    np.testing.assert_allclose(h.t[:2].numpy(), [5.0, 5.0], rtol=1e-5)


def _stand_in(size=16):
    path = os.path.join(SCENES, "config3_icosphere.toml")
    js, jc, jst = j_load(path)
    ts_, tc, tst = t_load(path, device="cpu")
    jc = JCamera.create(position=jc.position, yaw=jc.yaw, pitch=jc.pitch, fov_deg=jc.fov_deg, width=size, height=size)
    tc = dataclasses.replace(tc, width=size, height=size)
    kw = dict(width=size, height=size, spp=1, bounces=2, intersector="bvh")
    return (js, jc, dataclasses.replace(jst, **kw)), (ts_, tc, dataclasses.replace(tst, **kw))


def test_bvh_render_frame_matches_jax():
    (js, jc, jst), (ts_, tc, tst) = _stand_in()
    want = np.asarray(j_render(js, jc, jst))
    got = render_frame(ts_, tc, tst, device="cpu").numpy()
    assert want.mean() > 0.02 and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff.max(axis=-1) > 3e-2).mean() < 5e-3


def test_bvh_cache_rebuilds_after_an_in_place_edit():
    (_, _, _), (ts_, tc, tst) = _stand_in(size=12)
    before = render_frame(ts_, tc, tst, device="cpu")
    first = trenderer._cached_bvh(ts_)
    assert trenderer._cached_bvh(ts_) is first  # cached across frames
    with torch.no_grad():
        ts_.v0.add_(torch.tensor([0.3, 0.0, 0.0]))
    edited = render_frame(ts_, tc, tst, device="cpu")
    assert trenderer._cached_bvh(ts_) is not first
    fresh = dataclasses.replace(ts_, v0=ts_.v0.clone())  # new tensors: no cache entry
    assert torch.equal(edited, render_frame(fresh, tc, tst, device="cpu"))
    assert not torch.equal(edited, before)


def test_render_samples_refuses_bvh_as_jax_does():
    (js, jc, jst), (ts_, tc, tst) = _stand_in(size=8)
    with pytest.raises(ValueError):
        j_render_samples(js, jc, jst, 0, 1)
    with pytest.raises(ValueError, match="bvh"):
        render_samples(ts_, tc, tst, 0, 1, device="cpu")


@pytest.mark.parametrize("aov", ["normal", "normal_unit"])
def test_bvh_normal_aov_equals_the_kernel_route(aov):
    """The normal AOVs take one closest-hit search of the camera rays; the
    BVH's hits are the packed search's on this scene, so the AOVs are equal."""
    (_, _, _), (ts_, tc, tst) = _stand_in(size=16)
    tst = dataclasses.replace(tst, aov=aov)
    want = render_frame(ts_, tc, dataclasses.replace(tst, intersector="auto"), device="cpu")
    assert torch.equal(render_frame(ts_, tc, tst, device="cpu"), want) and want.abs().max() > 0
