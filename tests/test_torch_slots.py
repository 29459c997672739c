"""The live-slot contract of the four kernels: a packed triangle column is
exactly zero outside ``LIVE_SLOTS`` (the 25 (scalar, feature row) slots
that ``csrc/stream_stage.cuh`` stages and multiplies), ray features are zero
past row 9, and the kernels' own table is ``LIVE_SLOTS``. The JAX package's
pack has the same zeros. The searches take only the w of a pack marked
``live_slots_only``, and ``mark_live_slots`` marks a carried pack after
checking its zeros. Also the launch-shape table of the four kernels."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from gpupathtracer_tpu.models import scene as j_scene
from gpupathtracer_tpu.models.obj import MeshData as JMeshData
from gpupathtracer_tpu.ops import pallas_intersect as jpi
from gpupathtracer_tpu_torch import interop
from gpupathtracer_tpu_torch.models.obj import MeshData
from gpupathtracer_tpu_torch.models.scene import build_scene, mesh_spec, plane_spec, sphere_spec
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.ops.compaction import DEAD_DIR, DEAD_ORIGIN, compact_rays
from gpupathtracer_tpu_torch.ops.plucker import K, LIVE_SLOTS, NSCALARS, pack_rays
from gpupathtracer_tpu_torch.utils.config import load_scene_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "gpupathtracer_tpu_torch", "csrc", "stream_stage.cuh")


def _live_mask() -> np.ndarray:
    live = np.zeros((K, NSCALARS), bool)
    for s, k in LIVE_SLOTS:
        live[k, s] = True
    return live


def assert_live_slots_only(w) -> None:
    """``w`` (nb, K, 5·tb) is finite, and zero outside LIVE_SLOTS."""
    w = np.asarray(w)
    nb, tb = w.shape[0], w.shape[2] // NSCALARS
    grid = w.reshape(nb, K, NSCALARS, tb).transpose(1, 2, 0, 3)  # (K, 5, nb, tb)
    assert np.isfinite(w).all()
    assert not grid[~_live_mask()].any()
    assert grid[_live_mask()].any(axis=(1, 2)).all()  # every live slot is used somewhere


def _random_scene(seed):
    """One-sided and two-sided random triangles and a (two-sided) plane."""
    rng = np.random.default_rng(seed)

    def mk(n):
        v = rng.normal(size=(n, 3, 3)).astype(np.float32) * 2
        return MeshData(vertices=v, normals=np.zeros_like(v), uvs=np.zeros((n, 3, 2), np.float32))

    return build_scene(
        [mesh_spec(mk(300)), mesh_spec(mk(100), two_sided=True), plane_spec((0, 0, 0), (10, 20, 0), (3, 3, 3))],
        [{"type": "diffuse"}], pad_to_multiple=128, device="cpu",
    )


def _config_pack(name, which):
    scene, _, settings = load_scene_file(os.path.join(ROOT, "scenes", name), device="cpu")
    return tpi.pack_scene(scene, tri_block=getattr(settings, which)).w


def _streamed_pack(monkeypatch):
    """The padded w that the streamed searches get, with the route forced as
    tests/test_torch_stream.py forces it (4 blocks per cluster)."""
    monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 4 * K * NSCALARS * 64 * 4)
    scene = build_scene([sphere_spec(radius=2.0, subdivisions=3),
                         plane_spec((0.0, -2.0, 0.0), (90.0, 0.0, 0.0), (20.0, 20.0, 20.0))],
                        [{"type": "diffuse"}], pad_to_multiple=64, device="cpu")
    packed = tpi.pack_scene(scene, tri_block=64)
    assert tpi.route(packed.w.shape[0], packed.tri_block).streamed
    o = torch.zeros((64, 3))
    d = torch.nn.functional.normalize(torch.ones((64, 3)), dim=1)
    w = tpi.prepare_rays_streamed(o, d, packed)[-1]
    assert w.shape[0] % 4 == 0 and w.shape[0] > packed.w.shape[0]  # padded with dead blocks
    return w


PACKS = {
    **{f"random-tb{tb}": (lambda tb=tb: tpi.pack_scene(_random_scene(tb), tri_block=tb).w) for tb in (36, 100, 128, 512)},
    **{f"{cfg.split('_')[0]}-{which}": (lambda cfg=cfg, which=which: _config_pack(cfg, which))
       for cfg in ("config3_icosphere.toml", "config8_icosphere.toml") for which in ("tri_block", "tri_block_secondary")},
    "config5": lambda: _config_pack("config5_invert_target.toml", "tri_block"),
}


@pytest.mark.parametrize("case", list(PACKS) + ["streamed-padded"])
def test_pack_is_zero_outside_live_slots(case, monkeypatch):
    w = _streamed_pack(monkeypatch) if case == "streamed-padded" else PACKS[case]()
    assert_live_slots_only(w)


def _jax_scene(seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(200, 3, 3)).astype(np.float32)
    mesh = JMeshData(vertices=v, normals=np.zeros_like(v), uvs=np.zeros((200, 3, 2), np.float32))
    return j_scene.build_scene([j_scene.mesh_spec(mesh, two_sided=True)], [{"type": "diffuse"}], pad_to_multiple=128)


@pytest.mark.parametrize("tb", [36, 128])
def test_jax_pack_has_the_same_live_slots(tb):
    assert_live_slots_only(jpi.pack_scene(_jax_scene(tb), tri_block=tb).w)


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32) * 5)
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32)), dim=1)
    return o, d


def _random_features():
    return pack_rays(*_rays(1000))


def _padded_features():
    o, d = _rays(1000)
    feats = tpi.prepare_rays_streamed(o, d, tpi.pack_scene(_random_scene(1), tri_block=128))[3]
    assert feats.shape[0] == 1024  # 24 padded lanes
    return feats


def _dead_lane_features():
    o, d = _rays(1000)
    alive = torch.as_tensor(np.random.default_rng(2).uniform(size=1000) < 0.5)
    o_c, d_c, _ = compact_rays(o, d, alive)
    assert (o_c == torch.tensor(DEAD_ORIGIN)).all(dim=1).sum() == (~alive).sum()
    assert (d_c == torch.tensor(DEAD_DIR)).all(dim=1).sum() == (~alive).sum()
    return pack_rays(o_c, d_c)


@pytest.mark.parametrize("make", [_random_features, _padded_features, _dead_lane_features],
                         ids=["random", "padded", "dead-lanes"])
def test_ray_features_are_zero_past_row_9(make):
    feats = make()
    assert torch.isfinite(feats).all()
    assert (feats[:, 10:] == 0).all()
    assert (feats[:, 9] != 0).any()


def test_kernel_slot_table_is_live_slots():
    """The table in csrc/stream_stage.cuh, read as text, lists LIVE_SLOTS in
    order."""
    with open(HEADER) as f:
        text = f.read()
    body = re.search(r"LIVE_SLOTS\[NLIVE\] = \{(.*?)\};", text, re.S)
    assert body is not None
    table = tuple((int(s), int(k)) for s, k in re.findall(r"\{\s*(\d+)\s*,\s*(\d+)\s*\}", body.group(1)))
    assert table == LIVE_SLOTS
    assert len(LIVE_SLOTS) == 25 == len(set(LIVE_SLOTS))
    assert re.search(rf"constexpr int NLIVE = {len(LIVE_SLOTS)};", text)


def _carried_jax_pack(seed=3, tb=128):
    """JAX's pack carried across by interop, not marked."""
    jp = jpi.pack_scene(_jax_scene(seed), tri_block=tb)
    fields = interop.numpy_fields(jp, ["w", "tri_map", "box_lo", "box_hi", "block_live"])
    return interop.packed_from_numpy(fields, tri_block=tb, device="cpu")


RESIDENT = ("closest_hit", "occluded")


@pytest.mark.parametrize("case", ["pack_scene", "clone", "edited", "jax_pack"])
@pytest.mark.parametrize("search", ["closest_hit_streamed", "occluded_streamed", *RESIDENT])
def test_streamed_searches_take_only_live_slot_packs(search, case):
    """All four searches read only LIVE_SLOTS. A pack_scene pack's w (padded
    to whole clusters for the streamed ones) goes through; a copy of it, the
    same w edited in place, and JAX's pack carried across by interop (not
    marked, whatever its zeros) raise, on the CPU as on the card."""
    o, d = _rays(256, seed=3)
    packed = _carried_jax_pack() if case == "jax_pack" else tpi.pack_scene(_random_scene(3), tri_block=128)
    maxt = torch.full((256,), 5.0)
    if search in RESIDENT:
        prepare = tpi.prepare_rays(o, d, packed) if search == "closest_hit" else tpi.prepare_shadow_rays(o, d, maxt, packed)
        args, ray_tile = list(prepare) + [packed.w], tpi.DEFAULT_RAY_TILE
    else:
        prepare = tpi.prepare_rays_streamed if search == "closest_hit_streamed" else tpi.prepare_shadow_rays_streamed
        args = list(prepare(o, d, packed) if search == "closest_hit_streamed" else prepare(o, d, maxt, packed))
        ray_tile = tpi.STREAM_RAY_TILE
    w_at = len(args) - 1
    if case == "clone":
        args[w_at] = args[w_at].clone()
    elif case == "edited":
        args[w_at].mul_(1.0)
    if case != "pack_scene":
        with pytest.raises(ValueError, match="LIVE_SLOTS"):
            getattr(tpi, search)(*args, ray_tile)
        return
    got = getattr(tpi, search)(*args, ray_tile)
    want = getattr(tpi, f"{search}_reference")(*args, ray_tile)
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["jax_pack", "one_dead_slot"])
def test_mark_live_slots_checks_the_zeros(case):
    """mark_live_slots marks JAX's carried pack, which the resident searches
    then take; one nonzero value in a dead slot makes it raise."""
    carried = _carried_jax_pack()
    if case == "one_dead_slot":
        w = carried.w.clone()
        dead_k, dead_s = 12, 3  # feature row 12 of D: not in LIVE_SLOTS
        assert (dead_s, dead_k) not in LIVE_SLOTS
        w.view(w.shape[0], K, NSCALARS, -1)[1, dead_k, dead_s, 7] = 1e-30
        with pytest.raises(ValueError, match="LIVE_SLOTS"):
            tpi.mark_live_slots(dataclasses.replace(carried, w=w))
        return
    marked = tpi.mark_live_slots(carried)
    assert marked.live_slots_only and not carried.live_slots_only
    o, d = _rays(256, seed=4)
    args = tpi.prepare_rays(o, d, marked) + (marked.w, tpi.DEFAULT_RAY_TILE)
    bt, bi = tpi.closest_hit(*args)
    rt, ri = tpi.closest_hit_reference(*args)
    assert torch.equal(bt, rt) and torch.equal(bi, ri) and (bi >= 0).any()


@pytest.mark.parametrize("library", list(tpi.LAUNCH))
def test_launch_shapes_are_whole_warps(library):
    """For every ray tile the wrappers accept, the launch-shape table gives
    each column group a whole number of warps and the CTA at most 1,024
    threads (512 at two rays a thread, the kernels' launch bounds)."""
    for ray_tile in range(32, 1025, 32):
        threads, groups, rpt = tpi.launch_shape(library, ray_tile)
        per_group = ray_tile // rpt
        assert rpt in (1, 2) and per_group * rpt == ray_tile and per_group % 32 == 0, (ray_tile, rpt)
        assert groups >= 1 and threads == groups * per_group, (ray_tile, groups)
        assert threads <= (1024 if rpt == 1 else 512), (ray_tile, threads)
        if not library.startswith("closest_hit"):
            assert rpt == 1  # K2 and K4 are built for one ray a thread
