"""The port's packing, culling, schedule and closest-hit search against the
JAX package: packs and schedules equal, hits within the parity bar of
``intersect_pallas`` (interpret mode) and of the Möller–Trumbore oracle."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.models.obj import MeshData
from gpupathtracer_tpu.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu.ops import intersect as j_intersect
from gpupathtracer_tpu.ops import pallas_intersect as jpi
from gpupathtracer_tpu.utils.config import load_scene_file as j_load
from gpupathtracer_tpu_torch import interop
from gpupathtracer_tpu_torch.models.materials import MaterialTable
from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops import _build
from gpupathtracer_tpu_torch.ops import intersect as t_intersect
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")
HIT_AGREE = 0.9995  # parity bar (tests_tpu/test_onchip.py)


def to_port(js) -> TriangleScene:
    fields = interop.numpy_fields(js, [f.name for f in dataclasses.fields(TriangleScene) if f.name != "materials"])
    fields["materials"] = interop.numpy_fields(js.materials, [f.name for f in dataclasses.fields(MaterialTable)])
    return interop.scene_from_numpy(fields, device="cpu")


def random_scene(seed=0, pad=128, rays=800):
    """One-sided and two-sided random triangles plus a plane, and random rays
    (as tests/test_pallas_kernel.py builds them)."""
    rng = np.random.default_rng(seed)

    def mk(n, s):
        t = rng.normal(size=(n, 3, 3)).astype(np.float32) * s
        return MeshData(vertices=t, normals=np.zeros((n, 3, 3), np.float32), uvs=np.zeros((n, 3, 2), np.float32))

    js = build_scene(
        [mesh_spec(mk(150, 2)), mesh_spec(mk(50, 2), two_sided=True), plane_spec((0, 0, 0), (10, 20, 0), (3, 3, 3))],
        [{"type": "diffuse"}],
        pad_to_multiple=pad,
    )
    o = (rng.normal(size=(rays, 3)) * 4).astype(np.float32)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return js, o, d


@pytest.fixture(scope="module")
def stand_in():
    """The stand-in scene (JAX and port), camera rays through a 64×64 grid
    and random rays leaving the sphere's surface."""
    js, jc, _ = j_load(os.path.join(SCENES, "config3_icosphere.toml"))
    from gpupathtracer_tpu.models.camera import Camera, generate_rays

    jc = Camera.create(position=jc.position, yaw=jc.yaw, pitch=jc.pitch, fov_deg=jc.fov_deg, width=64, height=64)
    o, d = (np.asarray(x) for x in generate_rays(jc))
    rng = np.random.default_rng(4)
    p = rng.normal(size=(2000, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    d2 = rng.normal(size=(2000, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    d2 = np.where((d2 * p).sum(1, keepdims=True) < 0, -d2, d2)
    o2 = (p * 2.0 + 1e-3 * p).astype(np.float32)
    return js, to_port(js), (o, d), (o2, d2)


def _assert_pack_equal(jp, tp):
    np.testing.assert_array_equal(tp.tri_map.numpy(), np.asarray(jp.tri_map))
    np.testing.assert_array_equal(tp.block_live.numpy(), np.asarray(jp.block_live) > 0)
    for name in ("w", "box_lo", "box_hi"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("tb", [128, 512])
def test_pack_equal_jax(stand_in, tb):
    js, ts, _, _ = stand_in
    jp = jpi.pack_scene(js, tri_block=tb)
    tp = tpi.pack_scene(ts, tri_block=tb)
    assert tp.w.shape == tuple(jp.w.shape)
    _assert_pack_equal(jp, tp)
    assert tpi.pack_scene(ts, tri_block=tb) is tp  # cached on tensor identity


@pytest.mark.parametrize("alive_share", [None, 0.6])
@pytest.mark.parametrize("tb", [128, 512])
def test_schedule_equal_jax(stand_in, tb, alive_share):
    js, ts, (o, d), (o2, d2) = stand_in
    jp, tp = jpi.pack_scene(js, tri_block=tb), tpi.pack_scene(ts, tri_block=tb)
    for oo, dd in ((o, d), (o2[:1920], d2[:1920])):
        alive = None
        if alive_share is not None:
            alive = np.random.default_rng(1).uniform(size=oo.shape[0]) < alive_share
        jm, je = jpi.tile_block_mask(jnp.asarray(oo), jnp.asarray(dd), jp, 128, None if alive is None else jnp.asarray(alive))
        tm, te = tpi.tile_block_mask(torch.tensor(oo), torch.tensor(dd), tp, 128, None if alive is None else torch.tensor(alive))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        # XLA's CPU backend contracts the squared box distance into FMAs, so
        # an entry bound may differ from torch's in the last ulp.
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6, atol=0)
        jo, jes = jpi.plan_block_order(jm, je)
        to, tes = tpi.plan_block_order(tm, te)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_allclose(tes.numpy(), np.asarray(jes), rtol=1e-6, atol=0)


def assert_hit_bar(h, want_t, want_tri, want_hit):
    want_t, want_tri, want_hit = (np.asarray(x) for x in (want_t, want_tri, want_hit))
    tri, t = h.tri.numpy(), h.t.numpy()
    np.testing.assert_array_equal(h.hit.numpy(), tri >= 0)
    assert (tri == want_tri).mean() > HIT_AGREE
    same = (tri == want_tri) & want_hit
    np.testing.assert_allclose(t[same], want_t[same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,tb", [(0, 128), (1, 32), (2, 64)])
def test_random_scene_hits_match_pallas_and_oracle(seed, tb):
    js, o, d = random_scene(seed, pad=128)
    ts = to_port(js)
    jh = jpi.intersect_pallas(jnp.asarray(o), jnp.asarray(d), jpi.pack_scene(js, tri_block=tb), ray_tile=128, interpret=True)
    th = tpi.intersect_packed(torch.as_tensor(o), torch.as_tensor(d), tpi.pack_scene(ts, tri_block=tb))
    assert np.asarray(jh.hit).mean() > 0.2
    assert_hit_bar(th, jh.t, jh.tri, jh.hit)
    oracle = t_intersect.intersect_brute(torch.as_tensor(o), torch.as_tensor(d), ts, tri_block=128)
    assert_hit_bar(th, oracle.t, oracle.tri, oracle.hit)
    j_oracle = j_intersect.intersect_brute(jnp.asarray(o), jnp.asarray(d), js, tri_block=128)
    np.testing.assert_array_equal(oracle.tri.numpy(), np.asarray(j_oracle.tri))
    np.testing.assert_allclose(oracle.t.numpy(), np.asarray(j_oracle.t), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tb", [128, 512])
def test_stand_in_hits_match_pallas(stand_in, tb):
    js, ts, (o, d), (o2, d2) = stand_in
    jp, tp = jpi.pack_scene(js, tri_block=tb), tpi.pack_scene(ts, tri_block=tb)
    alive = np.random.default_rng(8).uniform(size=o2.shape[0]) < 0.7
    for oo, dd, al in ((o, d, None), (o2, d2, alive)):
        jh = jpi.intersect_pallas(jnp.asarray(oo), jnp.asarray(dd), jp, interpret=True,
                                  alive=None if al is None else jnp.asarray(al))
        th = tpi.intersect_packed(torch.tensor(oo), torch.tensor(dd), tp,
                                  alive=None if al is None else torch.tensor(al))
        assert np.asarray(jh.hit).mean() > 0.3
        assert_hit_bar(th, jh.t, jh.tri, jh.hit)


def test_closest_hit_on_cpu_runs_plain_version(stand_in):
    _, ts, (o, d), _ = stand_in
    tp = tpi.pack_scene(ts, tri_block=128)
    args = tpi.prepare_rays(torch.tensor(o), torch.tensor(d), tp) + (tp.w, tpi.DEFAULT_RAY_TILE)
    before = _build.launch_counts["closest_hit"]
    bt, bi = tpi.closest_hit(*args[:4], args[4], args[5])
    rt, ri = tpi.closest_hit_reference(*args[:4], args[4], args[5])
    assert _build.launch_counts["closest_hit"] == before  # no kernel launch on the CPU
    assert torch.equal(bt, rt) and torch.equal(bi, ri)
    assert bi.dtype == torch.int32 and bt.dtype == torch.float32


def test_closest_hit_checks_inputs(stand_in):
    _, ts, (o, d), _ = stand_in
    tp = tpi.pack_scene(ts, tri_block=128)
    order, enter, feats, alive = tpi.prepare_rays(torch.tensor(o), torch.tensor(d), tp)
    bad = [
        (order.long(), enter, feats, alive, tp.w, 128),
        (order, enter.double(), feats, alive, tp.w, 128),
        (order, enter, feats[:-1], alive, tp.w, 128),
        (order, enter, feats, alive.bool(), tp.w, 128),
        (order, enter, feats, alive, tp.w[:, :, :-1], 128),
        (order, enter, feats, alive, tp.w.transpose(1, 2).contiguous().transpose(1, 2), 128),
        (order, enter, feats, alive, tp.w, 100),
        (order, enter, feats, alive, tp.w, 2048),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tpi.closest_hit(*args)


def test_search_on_the_jax_pack(stand_in):
    """interop.packed_from_numpy carries JAX's pack across and
    mark_live_slots checks and marks it; the port's search on it finds the
    same packed rows as on the port's own pack."""
    js, ts, (o, d), _ = stand_in
    jp = jpi.pack_scene(js, tri_block=128)
    fields = interop.numpy_fields(jp, ["w", "tri_map", "box_lo", "box_hi", "block_live"])
    carried = tpi.mark_live_slots(interop.packed_from_numpy(fields, tri_block=jp.tri_block, device="cpu"))
    own = tpi.pack_scene(ts, tri_block=128)
    o, d = torch.tensor(o), torch.tensor(d)
    h_carried = tpi.intersect_packed(o, d, carried)
    h_own = tpi.intersect_packed(o, d, own)
    assert (h_carried.tri == h_own.tri).double().mean().item() > HIT_AGREE
    same = (h_carried.tri == h_own.tri) & h_own.hit
    torch.testing.assert_close(h_carried.t[same], h_own.t[same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,tb,ray_tile", [(7, 128, 128), (8, 64, 256), (9, 32, 64)])
def test_occluded_matches_pallas_and_thresholded_oracle(seed, tb, ray_tile):
    """Cutoffs on both sides of each ray's true hit distance (as
    tests/test_pallas_kernel.py draws them), a third of the lanes dead
    (max_t = 0): the plain any-hit search against
    ``intersect_pallas_occluded(interpret=True)`` and against the thresholded
    Möller–Trumbore oracle."""
    js, o, d = random_scene(seed, pad=128)
    ts = to_port(js)
    rng = np.random.default_rng(seed)
    oracle = t_intersect.intersect_brute(torch.as_tensor(o), torch.as_tensor(d), ts, tri_block=128)
    t_ref, hit_ref = oracle.t.numpy(), oracle.hit.numpy()
    scale = rng.uniform(0.3, 2.0, size=t_ref.shape).astype(np.float32)
    t_finite = np.where(hit_ref, t_ref, 1.0)  # miss lanes carry t = BIG
    max_t = np.where(hit_ref, t_finite * scale, rng.uniform(0.5, 5.0, t_ref.shape))
    dead = rng.uniform(size=t_ref.shape) < 1 / 3
    max_t = np.where(dead, 0.0, max_t).astype(np.float32)
    want_j = np.asarray(jpi.intersect_pallas_occluded(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_t), jpi.pack_scene(js, tri_block=tb),
        ray_tile=ray_tile, interpret=True,
    ))
    got = tpi.intersect_packed_occluded(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(max_t), tpi.pack_scene(ts, tri_block=tb),
        ray_tile=ray_tile, plain=True,
    ).numpy()
    expect = hit_ref & (t_ref < max_t)
    assert expect.sum() > 50 and (~expect & ~dead).sum() > 50  # both outcomes exercised
    assert (got == want_j).mean() >= HIT_AGREE and (got == expect).mean() >= HIT_AGREE
    assert not got[dead].any()


def test_occluded_on_cpu_runs_plain_version(stand_in):
    """On CPU tensors ``occluded`` runs its plain version (no launch counted),
    returns int32 flags, and checks its inputs as the closest hit does."""
    _, ts, _, (o2, d2) = stand_in
    tp = tpi.pack_scene(ts, tri_block=512)
    maxt = torch.where(torch.arange(o2.shape[0]) % 4 == 0, 0.0, 3.0)
    args = tpi.prepare_shadow_rays(torch.tensor(o2), torch.tensor(d2), maxt, tp)
    assert args[2].shape[0] % tpi.DEFAULT_RAY_TILE == 0 and (args[3][o2.shape[0]:] == 0).all()
    before = _build.launch_counts["occlusion"]
    occ = tpi.occluded(*args, tp.w)
    assert _build.launch_counts["occlusion"] == before
    ref, work = tpi.occluded_reference(*args, tp.w, count_work=True)
    assert occ.dtype == torch.int32 and torch.equal(occ, ref)
    assert 0 < occ.sum() < (maxt > 0).sum() and work["blocks"] > 0 and work["lane_blocks"] > 0
    order, enter, feats, mt = args
    for bad in [(order, enter, feats, mt.double(), tp.w), (order, enter, feats, mt[:-1], tp.w),
                (order, enter, feats, mt.to(torch.int32), tp.w)]:
        with pytest.raises(ValueError):
            tpi.occluded(*bad)
