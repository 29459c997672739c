"""The port's streamed route (packs past ``RESIDENT_BUDGET_BYTES``) against
the JAX package: the cluster plan, padding and schedule equal, both streamed
searches within the parity bars of ``intersect_pallas`` and
``intersect_pallas_occluded`` (interpret mode), the sorted intersect, the
sort autos, streamed renders and where the streamed searches run.

Small scenes are forced onto the streamed route by patching
``RESIDENT_BUDGET_BYTES`` (and ``CLUSTER_TARGET_BYTES``, for several blocks
per cluster) in both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_intersect import HIT_AGREE, assert_hit_bar, random_scene, to_port
from test_torch_render import _counting, _resized, assert_image_bar

from gpupathtracer_tpu.models import scene as j_scene
from gpupathtracer_tpu.ops import pallas_intersect as jpi
from gpupathtracer_tpu.ops.intersect import Hit as JHit
from gpupathtracer_tpu.render.renderer import narrow_settings as j_narrow
from gpupathtracer_tpu.render.renderer import render_frame as j_render
from gpupathtracer_tpu_torch.models import scene as t_scene
from gpupathtracer_tpu_torch.ops import _build
from gpupathtracer_tpu_torch.ops import intersect as t_intersect
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.ops.intersect import Hit
from gpupathtracer_tpu_torch.render.renderer import RenderSettings
from gpupathtracer_tpu_torch.render.renderer import narrow_settings as t_narrow
from gpupathtracer_tpu_torch.render.renderer import render_frame


def force_streamed(monkeypatch, cluster_bytes=None, budget=1024):
    """Send every pack larger than ``budget`` bytes to the streamed route in
    both packages, with clusters of about ``cluster_bytes``."""
    for mod in (jpi, tpi):
        monkeypatch.setattr(mod, "RESIDENT_BUDGET_BYTES", budget)
        if cluster_bytes is not None:
            monkeypatch.setattr(mod, "CLUSTER_TARGET_BYTES", cluster_bytes)


def is_streamed(packed) -> bool:
    """Whether ``packed`` takes the streamed route (``tpi.route``)."""
    return tpi.route(packed.w.shape[0], packed.tri_block).streamed


def _icosphere_scenes(subdivisions=3):
    """An icosphere on a floor plane, built in both packages from the same
    specs."""
    def specs(m):
        return [m.sphere_spec(radius=2.0, subdivisions=subdivisions),
                m.plane_spec((0.0, -2.0, 0.0), (90.0, 0.0, 0.0), (20.0, 20.0, 20.0))]

    mats = [{"type": "diffuse"}]
    return (j_scene.build_scene(specs(j_scene), mats, pad_to_multiple=64),
            t_scene.build_scene(specs(t_scene), mats, pad_to_multiple=64, device="cpu"))


@pytest.fixture(scope="module")
def streamed_case():
    """icosphere(3) on a floor, and 1,000 rays (not a tile multiple) aimed
    through the sphere's box from around it."""
    js, ts = _icosphere_scenes()
    rng = np.random.default_rng(0)
    r = 1000
    o = rng.uniform(-6.0, 6.0, (r, 3)).astype(np.float32)
    d = rng.uniform(-2.0, 2.0, (r, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.uniform(size=r) < 0.8
    return js, ts, o, d, alive


@pytest.mark.parametrize("tb,cluster_bytes", [(32, 1 << 20), (64, 64 * 1024), (128, 100 * 1024)])
def test_plan_and_padding_equal_jax(streamed_case, tb, cluster_bytes, monkeypatch):
    force_streamed(monkeypatch, cluster_bytes)
    js, ts, _, _, _ = streamed_case
    jp, tp = jpi.pack_scene(js, tri_block=tb), tpi.pack_scene(ts, tri_block=tb)
    nb = tp.w.shape[0]
    bpc = tpi.route(nb, tb).bpc
    assert bpc == jpi._plan_stream_shape(nb, 640, 64, tb)[1]
    assert is_streamed(tp)
    jpad, tpad = jpi._pad_blocks(jp, bpc), tpi._pad_blocks(tp, bpc)
    assert tpad.w.shape[0] % bpc == 0 and tpad.w.shape == tuple(jpad.w.shape)
    np.testing.assert_array_equal(tpad.tri_map.numpy(), np.asarray(jpad.tri_map))
    np.testing.assert_array_equal(tpad.block_live.numpy(), np.asarray(jpad.block_live) > 0)
    for name in ("w", "box_lo", "box_hi"):
        np.testing.assert_allclose(getattr(tpad, name).numpy(), np.asarray(getattr(jpad, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("tb,cluster_bytes", [(64, 16 * 1024), (64, 64 * 1024)])
@pytest.mark.parametrize("alive_share", [None, 0.5])
def test_cluster_schedule_equal_jax(streamed_case, tb, cluster_bytes, alive_share, monkeypatch):
    """The cluster schedule of ``intersect_pallas`` (its streamed branch),
    rebuilt from the JAX package's functions, against the port's."""
    force_streamed(monkeypatch, cluster_bytes)
    js, ts, o, d, _ = streamed_case
    o, d = o[:960], d[:960]
    alive = None if alive_share is None else np.random.default_rng(3).uniform(size=960) < alive_share
    jp, tp = jpi.pack_scene(js, tri_block=tb), tpi.pack_scene(ts, tri_block=tb)
    bpc = tpi.route(tp.w.shape[0], tb).bpc
    jpad, tpad = jpi._pad_blocks(jp, bpc), tpi._pad_blocks(tp, bpc)
    rt = 960 // 64
    jm, je = jpi.tile_block_mask(jnp.asarray(o), jnp.asarray(d), jpad, 64,
                                 None if alive is None else jnp.asarray(alive))
    j_enter_blk = jnp.where(jm > 0, je, jpi.INF)
    j_order, j_sorted = jpi.plan_block_order(
        jm.reshape(rt, -1, bpc).max(axis=-1), jnp.min(j_enter_blk.reshape(rt, -1, bpc), axis=-1)
    )
    tm, te = tpi.tile_block_mask(torch.tensor(o), torch.tensor(d), tpad, 64,
                                 None if alive is None else torch.tensor(alive))
    t_order, t_sorted, t_enter_blk = tpi.cluster_schedule(tm, te, bpc)
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))
    # XLA's CPU backend contracts the squared box distance into FMAs, so an
    # entry bound may differ from torch's in the last ulp.
    np.testing.assert_allclose(t_sorted.numpy(), np.asarray(j_sorted), rtol=1e-6, atol=0)
    np.testing.assert_allclose(t_enter_blk.numpy(), np.asarray(j_enter_blk), rtol=1e-6, atol=0)
    assert (t_order.numpy() < t_order.shape[1]).any()  # some tile schedules a cluster


# bpc 1, 3 and 4
@pytest.mark.parametrize("tb,cluster_bytes", [(64, 16 * 1024), (64, 64 * 1024), (32, 48 * 1024)])
def test_streamed_hits_match_pallas(streamed_case, tb, cluster_bytes, monkeypatch):
    """``intersect_packed`` on the streamed route (plain version on the CPU)
    against ``intersect_pallas(interpret=True)``, with dead lanes and a
    padded last tile, one and several blocks per cluster."""
    force_streamed(monkeypatch, cluster_bytes)
    js, ts, o, d, alive = streamed_case
    jp, tp = jpi.pack_scene(js, tri_block=tb), tpi.pack_scene(ts, tri_block=tb)
    jh = jpi.intersect_pallas(jnp.asarray(o), jnp.asarray(d), jp, interpret=True, alive=jnp.asarray(alive))
    before = _build.launch_counts["closest_hit_streamed"]
    th = tpi.intersect_packed(torch.tensor(o), torch.tensor(d), tp, alive=torch.tensor(alive))
    assert _build.launch_counts["closest_hit_streamed"] == before  # no kernel launch on the CPU
    assert np.asarray(jh.hit).mean() > 0.3 and not th.hit.numpy()[~alive].any()
    assert_hit_bar(th, jh.t, jh.tri, jh.hit)


def test_streamed_reference_counts_its_work(streamed_case, monkeypatch):
    """The plain version's work: every computed (tile, block) pair passed its
    entry test, and an all-dead tile computes nothing."""
    force_streamed(monkeypatch, 64 * 1024)
    _, ts, o, d, alive = streamed_case
    tp = tpi.pack_scene(ts, tri_block=64)
    alive = alive.copy()
    alive[:64] = False  # one all-dead tile
    args = tpi.prepare_rays_streamed(torch.tensor(o), torch.tensor(d), tp, torch.tensor(alive))
    bt, bi, work = tpi.closest_hit_streamed_reference(*args, count_work=True)
    assert (args[0][0] == args[0].shape[1]).all()  # the dead tile schedules nothing
    assert torch.isneginf(bt[:64]).all() and (bi[:64] == -1).all()
    nb = args[5].shape[0]
    assert 0 < work["blocks"] < nb * args[0].shape[0]
    assert work["lane_blocks"] <= 64 * work["blocks"]
    rt, ri = tpi.closest_hit_streamed(*args)
    assert torch.equal(rt, bt) and torch.equal(ri, bi)


@pytest.mark.parametrize("tb,cluster_bytes", [(64, 16 * 1024), (32, 48 * 1024)])
def test_streamed_occlusion_matches_pallas_and_oracle(tb, cluster_bytes, monkeypatch):
    """Cutoffs on both sides of each ray's true hit distance, a third of the
    lanes dead (max_t = 0): flags exactly JAX's, within the bar of the
    thresholded Möller–Trumbore oracle, and no dead lane occluded."""
    force_streamed(monkeypatch, cluster_bytes)
    js, o, d = random_scene(11, pad=128, rays=512)
    ts = to_port(js)
    rng = np.random.default_rng(11)
    oracle = t_intersect.intersect_brute(torch.as_tensor(o), torch.as_tensor(d), ts, tri_block=128)
    t_ref, hit_ref = oracle.t.numpy(), oracle.hit.numpy()
    scale = rng.uniform(0.3, 2.0, size=t_ref.shape).astype(np.float32)
    max_t = np.where(hit_ref, np.where(hit_ref, t_ref, 1.0) * scale, rng.uniform(0.5, 5.0, t_ref.shape))
    dead = rng.uniform(size=t_ref.shape) < 1 / 3
    max_t = np.where(dead, 0.0, max_t).astype(np.float32)
    jp, tp = jpi.pack_scene(js, tri_block=tb), tpi.pack_scene(ts, tri_block=tb)
    assert is_streamed(tp)
    want = np.asarray(jpi.intersect_pallas_occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_t), jp,
                                                    interpret=True))
    got = tpi.intersect_packed_occluded(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(max_t), tp).numpy()
    expect = hit_ref & (t_ref < max_t)
    assert expect.sum() > 50 and (~expect & ~dead).sum() > 50
    np.testing.assert_array_equal(got, want)
    assert (got == expect).mean() >= HIT_AGREE
    assert not got[dead].any()


@pytest.mark.parametrize("key_mode", ["dir", "origin"])
def test_sorted_intersect_equal_jax(streamed_case, key_mode, monkeypatch):
    """``make_sorted_intersect``: the wrapped search sees JAX's permutation
    of the rays, results come back in the caller's order, and on a streamed
    pack the hits meet the bar against JAX's sorted ``intersect_pallas``."""
    force_streamed(monkeypatch, 64 * 1024)
    js, ts, o, d, _ = streamed_case
    jp, tp = jpi.pack_scene(js, tri_block=64), tpi.pack_scene(ts, tri_block=64)
    seen = {}

    def j_probe(oo, dd, _scene):
        seen["j"] = np.asarray(oo)
        return JHit(t=jnp.arange(oo.shape[0], dtype=jnp.float32), tri=jnp.zeros(oo.shape[0], jnp.int32),
                    hit=jnp.ones(oo.shape[0], bool))

    def t_probe(oo, dd, alive=None):
        seen["t"] = oo.numpy()
        return Hit(t=torch.arange(oo.shape[0], dtype=torch.float32), tri=torch.zeros(oo.shape[0], dtype=torch.long),
                   hit=torch.ones(oo.shape[0], dtype=torch.bool))

    jt = np.asarray(jpi.make_sorted_intersect(j_probe, jp, key_mode)(jnp.asarray(o), jnp.asarray(d), js).t)
    tt = tpi.make_sorted_intersect(t_probe, tp, key_mode)(torch.tensor(o), torch.tensor(d)).t.numpy()
    np.testing.assert_array_equal(seen["t"], seen["j"])
    np.testing.assert_array_equal(tt, jt)
    assert not np.array_equal(seen["t"], o)  # the sort moved rays

    jh = jpi.make_sorted_intersect(lambda oo, dd, _s: jpi.intersect_pallas(oo, dd, jp, interpret=True), jp,
                                   key_mode)(jnp.asarray(o), jnp.asarray(d), js)
    th = tpi.make_sorted_intersect(lambda oo, dd, alive=None: tpi.intersect_packed(oo, dd, tp, alive=alive), tp,
                                   key_mode)(torch.tensor(o), torch.tensor(d))
    assert_hit_bar(th, jh.t, jh.tri, jh.hit)


@pytest.mark.parametrize(
    "budget,change,want",
    [
        (None, {}, (False, "dir")),
        (1 << 20, {}, (True, "origin")),
        (1 << 20, {"sort_rays": False}, (False, "origin")),
        (1 << 20, {"sort_key": "dir"}, (True, "dir")),
        (None, {"sort_rays": True}, (True, "dir")),
    ],
)
def test_sort_autos_resolve_as_jax(budget, change, want, monkeypatch):
    """``narrow_settings`` resolves ``sort_rays``/``sort_key`` by the primary
    pack's size as the JAX package does; an explicit value wins."""
    if budget is not None:
        force_streamed(monkeypatch, budget=budget)
    (js, _, jst), (ts_, _, tst) = _resized("config3_icosphere.toml", 8, 1)
    jn = j_narrow(js, dataclasses.replace(jst, **change))
    tn = t_narrow(ts_, dataclasses.replace(tst, **change))
    assert (tn.sort_rays, tn.sort_key) == (jn.sort_rays, jn.sort_key) == want


@pytest.mark.parametrize(
    "config,size,spp,change",
    [
        ("config3_icosphere.toml", 24, 1, {}),
        # NEE: bounce 0's shadow rays threshold the streamed closest hit, the
        # scan bounces' take the streamed any-hit search.
        ("config8_icosphere.toml", 32, 2, {}),
        # Compaction off: every closest hit is sorted around the call.
        ("config3_icosphere.toml", 16, 1, {"compact": False, "sort_rays": True}),
    ],
)
def test_streamed_render_matches_jax(config, size, spp, change, monkeypatch):
    force_streamed(monkeypatch, budget=1 << 20)
    (js, jc, jst), (ts_, tc, tst) = _resized(config, size, spp)
    jst, tst = dataclasses.replace(jst, **change), dataclasses.replace(tst, **change)
    assert t_narrow(ts_, tst).sort_rays and j_narrow(js, jst).sort_rays
    want = np.asarray(j_render(js, jc, jst))
    got = render_frame(ts_, tc, tst, device="cpu").numpy()
    assert got.shape == want.shape and want.mean() > 0.05
    assert_image_bar(got, want)


@pytest.mark.parametrize(
    "config,budget,change,calls",
    [
        # (closest_hit, occluded, closest_hit_streamed, occluded_streamed) per
        # sample: B + 1 closest hits (bounce 0's shadow rays thresholded) and
        # B - 1 any hits on the scan bounces.
        ("config8_icosphere.toml", 1 << 20, {}, (0, 0, 4, 2)),
        ("config3_icosphere.toml", 1 << 20, {}, (0, 0, 4, 0)),
        ("config8_icosphere.toml", None, {}, (4, 2, 0, 0)),
        ("config3_icosphere.toml", None, {}, (4, 0, 0, 0)),
    ],
)
def test_streamed_searches_run_only_on_streamed_packs(monkeypatch, config, budget, change, calls):
    if budget is not None:
        force_streamed(monkeypatch, budget=budget)
    (_, _, _), (ts_, tc, tst) = _resized(config, 16, 1)
    stubs = [
        _counting(monkeypatch, "closest_hit", tpi.closest_hit_reference),
        _counting(monkeypatch, "occluded", tpi.occluded_reference),
        _counting(monkeypatch, "closest_hit_streamed", tpi.closest_hit_streamed_reference),
        _counting(monkeypatch, "occluded_streamed", tpi.occluded_streamed_reference),
    ]
    img = render_frame(ts_, tc, dataclasses.replace(tst, **change), device="cpu")
    assert torch.isfinite(img).all()
    assert tuple(s.calls for s in stubs) == calls


@pytest.mark.parametrize("over", [False, True], ids=["just_under", "just_over"])
def test_one_route_rule_for_sort_autos_and_searches(streamed_case, over, monkeypatch):
    """``narrow_settings``' sort autos and the route that the searches take
    follow one rule (``tpi.route``): with the resident budget patched so that
    the primary pack lies just under it, neither sorts nor streams; one byte
    lower, both do."""
    _, ts, o, d, _ = streamed_case
    tb = 64
    packed = tpi.pack_scene(ts, tri_block=tb)
    monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", packed.w.numel() * 4 - int(over))
    narrowed = t_narrow(ts, RenderSettings(tri_block=tb))
    assert (narrowed.sort_rays, narrowed.sort_key) == ((True, "origin") if over else (False, "dir"))
    stubs = [
        _counting(monkeypatch, "closest_hit", tpi.closest_hit_reference),
        _counting(monkeypatch, "occluded", tpi.occluded_reference),
        _counting(monkeypatch, "closest_hit_streamed", tpi.closest_hit_streamed_reference),
        _counting(monkeypatch, "occluded_streamed", tpi.occluded_streamed_reference),
    ]
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    tpi.intersect_packed(o, d, packed)
    tpi.intersect_packed_occluded(o, d, torch.full((o.shape[0],), 5.0), packed)
    assert tuple(s.calls for s in stubs) == ((0, 0, 1, 1) if over else (1, 1, 0, 0))
