"""The streamed closest hit's traversal modes on the port, as
tests/test_stream_modes.py holds the JAX package's: a cluster budget with
the two-phase straggler regroup, sub-tile gating and fresh-worst gating
give hits bit-identical to the single-phase search, and agree with the JAX
package's ``intersect_pallas`` (interpret mode) under the same module
constants; the budgeted search's per-lane ``done`` flags equal the JAX
kernel's on the same inputs and seeds and are sound (a lane reported done
already holds its single-phase hit).

The scene is the icosphere on a floor of tests/test_torch_stream.py (the
JAX test's sphereBlender.obj is not in the repository), forced onto the
streamed route in both packages with clusters of 3 blocks of 64 rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_intersect import assert_hit_bar
from test_torch_stream import _icosphere_scenes, is_streamed

from gpupathtracer_tpu.ops import pallas_intersect as jpi
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi

TB = 64
RAY_TILE = 64
# (budget, subtiles, fresh): the cases of tests/test_stream_modes.py.
CASES = [(1, 1, False), (2, 1, False), (0, 2, False), (0, 4, False), (2, 4, False), (0, 1, True), (2, 1, True)]


def _with_overrides(mp, budget=0, subtiles=1, fresh=False):
    for mod in (jpi, tpi):
        mp.setattr(mod, "RESIDENT_BUDGET_BYTES", 1024)  # force streamed
        mp.setattr(mod, "CLUSTER_TARGET_BYTES", 64 * 1024)
        mp.setattr(mod, "STREAM_PHASE1_BUDGET", budget)
        mp.setattr(mod, "STREAM_SUBTILES", subtiles)
        mp.setattr(mod, "STREAM_FRESH_WORST", fresh)


@pytest.fixture(scope="module")
def streamed_case():
    """The packs of both packages, 512 rays from around the sphere aimed at
    points inside its box, 80% of them alive, and the port's single-phase
    hits."""
    js, ts = _icosphere_scenes()
    rng = np.random.default_rng(1)
    r = 512
    lo, hi = np.full(3, -2.0), np.full(3, 2.0)
    targets = rng.uniform(lo, hi, (r, 3)).astype(np.float32)
    o = rng.uniform(lo - 3, hi + 3, (r, 3)).astype(np.float32)
    d = targets - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.random(r) > 0.2
    jp, tp = jpi.pack_scene(js, tri_block=TB), tpi.pack_scene(ts, tri_block=TB)
    rays = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(alive))
    with pytest.MonkeyPatch.context() as mp:
        _with_overrides(mp)
        assert is_streamed(tp)
        ref = tpi.intersect_packed(*rays[:2], tp, alive=rays[2])
        prepared = tpi.prepare_rays_streamed(*rays[:2], tp, alive=rays[2])
    assert ref.hit.double().mean() > 0.5
    return jp, tp, (o, d, alive), rays, ref, prepared


def _assert_same_hits(a, b):
    for f in ("t", "tri", "hit"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("budget,subtiles,fresh", CASES)
def test_stream_modes_bit_identical(streamed_case, monkeypatch, budget, subtiles, fresh):
    jp, tp, (o, d, alive), rays, ref, prepared = streamed_case
    _with_overrides(monkeypatch, budget=budget, subtiles=subtiles, fresh=fresh)
    got = tpi.intersect_packed(*rays[:2], tp, alive=rays[2])
    _assert_same_hits(got, ref)
    want = jpi.intersect_pallas(jnp.asarray(o), jnp.asarray(d), jp, interpret=True, alive=jnp.asarray(alive))
    assert_hit_bar(got, want.t, want.tri, want.hit)
    if subtiles > 1 or fresh:
        # The gates only ever skip work. These rays are incoherent, so the
        # entry bounds are near 0 and the gates skip nothing here.
        single = tpi.closest_hit_streamed_reference(*prepared, RAY_TILE, count_work=True)[-1]
        gated = tpi.closest_hit_streamed_reference(*prepared, RAY_TILE, count_work=True, subtiles=subtiles,
                                                   fresh=fresh)[-1]
        assert gated["lane_blocks"] <= single["lane_blocks"]


@pytest.mark.parametrize("subtiles,fresh", [(2, False), (4, False), (1, True)])
def test_gates_skip_work_on_coherent_rays(streamed_case, monkeypatch, subtiles, fresh):
    """Rays from near one point, all aimed into the sphere: the gated modes
    compute fewer (lane, block) pairs than the single-phase search, with the
    same hits."""
    _, tp = streamed_case[:2]
    _with_overrides(monkeypatch)
    rng = np.random.default_rng(2)
    o = (np.array([0.0, 1.0, 10.0]) + rng.normal(size=(512, 3)) * 0.01).astype(np.float32)
    d = rng.uniform(-1.0, 1.0, (512, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    prepared = tpi.prepare_rays_streamed(torch.as_tensor(o), torch.as_tensor(d), tp)
    *single, work = tpi.closest_hit_streamed_reference(*prepared, RAY_TILE, count_work=True)
    *gated, gated_work = tpi.closest_hit_streamed_reference(*prepared, RAY_TILE, count_work=True,
                                                            subtiles=subtiles, fresh=fresh)
    assert all(torch.equal(a, b) for a, b in zip(gated, single))
    assert gated_work["lane_blocks"] < work["lane_blocks"]


@pytest.mark.parametrize("seeds", ["unseeded", "resumed"])
def test_phase1_done_flags_are_sound(streamed_case, seeds):
    """The budgeted plain search (budget 1) against the JAX package's
    ``_launch_streamed`` on the same inputs and seeds: equal ``done`` flags,
    hits at the hit bar; every live lane reported done holds its
    single-phase triangle, and some live lanes are left undone. "resumed"
    seeds the lanes with the partial hits of a first budgeted call."""
    jp, tp, _, _, ref, prepared = streamed_case
    order, enter, enter_blk, feats, alive_i, w = prepared
    live = alive_i > 0
    init_t = torch.where(live, tpi.BIG, -tpi.INF).to(torch.float32)
    init_i = torch.full_like(alive_i, -1)
    if seeds == "resumed":
        init_t, init_i = tpi.closest_hit_streamed_reference(*prepared, RAY_TILE, init_t=init_t, init_i=init_i,
                                                            budget=1)
    bt, bi, done = tpi.closest_hit_streamed_reference(*prepared, RAY_TILE, init_t=init_t, init_i=init_i, budget=1,
                                                      with_done=True)
    bpc = w.shape[0] // order.shape[1]
    j = lambda x: jnp.asarray(x.numpy())
    bt_j, bi_j, done_j = jpi._launch_streamed(j(order), j(enter), j(enter_blk), j(feats), j(alive_i), j(init_t),
                                              j(init_i), j(w), RAY_TILE, bpc, True, "highest", budget=1)
    np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
    assert (bi.numpy() == np.asarray(bi_j)).mean() >= 0.9995
    same = (bi.numpy() == np.asarray(bi_j)) & (bi.numpy() >= 0)
    np.testing.assert_allclose(bt.numpy()[same], np.asarray(bt_j)[same], rtol=1e-5, atol=1e-5)

    r = ref.tri.shape[0]
    tri = torch.where(bi >= 0, tp.tri_map[bi.long().clamp(min=0)], -1)[:r]
    done_live = ((done > 0) & live)[:r]
    assert torch.equal(tri[done_live], ref.tri[done_live])
    assert ((done == 0) & live).any()
