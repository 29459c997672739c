"""The closest-hit and any-hit CUDA kernels, resident and streamed, against
their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gpupathtracer_tpu_torch.models.obj import MeshData
from gpupathtracer_tpu_torch.models.scene import build_scene, mesh_spec, plane_spec
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils.config import load_scene_file

pytestmark = pytest.mark.cuda

SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes", "config3_icosphere.toml")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_scene(device, seed=0, rays=3000):
    rng = np.random.default_rng(seed)

    def mk(n):
        v = rng.normal(size=(n, 3, 3)).astype(np.float32) * 2
        return MeshData(vertices=v, normals=np.zeros_like(v), uvs=np.zeros((n, 3, 2), np.float32))

    scene = build_scene(
        [mesh_spec(mk(700)), mesh_spec(mk(200), two_sided=True), plane_spec((0, 0, 0), (10, 20, 0), (3, 3, 3))],
        [{"type": "diffuse"}],
        pad_to_multiple=128,
        device=device,
    )
    o = torch.as_tensor(rng.normal(size=(rays, 3)).astype(np.float32) * 4, device=device)
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(rays, 3)).astype(np.float32), device=device), dim=1)
    return scene, o, d


@pytest.mark.parametrize("tb,ray_tile", [(128, 128), (512, 128), (64, 64), (100, 32), (36, 256)])
def test_kernel_matches_plain_version(device, tb, ray_tile):
    scene, o, d = _random_scene(device, seed=tb)
    packed = tpi.pack_scene(scene, tri_block=tb)
    alive = torch.rand(o.shape[0], generator=torch.Generator().manual_seed(1)) < 0.8
    args = tpi.prepare_rays(o, d, packed, alive=alive.to(device), ray_tile=ray_tile) + (packed.w, ray_tile)
    before = tpi.closest_hit.launches
    bt, bi = tpi.closest_hit(*args)
    assert tpi.closest_hit.launches == before + 1
    rt, ri = tpi.closest_hit_reference(*args)
    torch.cuda.synchronize()
    assert (bi == ri).double().mean().item() > 0.9995
    same = (bi == ri) & (ri >= 0)
    assert same.sum() > 100
    torch.testing.assert_close(bt[same], rt[same], rtol=1e-5, atol=1e-5)
    dead = args[3] == 0
    assert (bi[dead] == -1).all() and torch.isneginf(bt[dead]).all()


@pytest.mark.parametrize("tb,ray_tile", [(128, 128), (512, 128), (64, 64), (100, 32), (36, 256)])
def test_occlusion_kernel_matches_plain_version(device, tb, ray_tile):
    """Cutoffs on both sides of each ray's true hit distance, some lanes at
    maxt = 0."""
    scene, o, d = _random_scene(device, seed=tb + 1)
    packed = tpi.pack_scene(scene, tri_block=tb)
    hit = tpi.intersect_packed(o, d, packed)
    g = torch.Generator().manual_seed(2)
    scale = (0.5 + torch.rand(o.shape[0], generator=g)).to(device)
    maxt = torch.where(hit.hit, hit.t * scale, 20.0 * scale)
    maxt = torch.where(torch.rand(o.shape[0], generator=g).to(device) < 0.1, 0.0, maxt)
    args = tpi.prepare_shadow_rays(o, d, maxt, packed, ray_tile=ray_tile) + (packed.w, ray_tile)
    before = tpi.occluded.launches
    occ = tpi.occluded(*args)
    assert tpi.occluded.launches == before + 1
    ref = tpi.occluded_reference(*args)
    torch.cuda.synchronize()
    assert occ.dtype == torch.int32
    assert (occ == ref).double().mean().item() >= 0.9995
    assert 0.1 < ref.double().mean().item() < 0.9
    assert (occ[args[3] == 0] == 0).all()


@pytest.mark.parametrize("tb", [128, 512])
def test_kernel_breaks_visit_order_ties_as_plain_version(device, tb):
    """Two blocks with the same columns (every triangle at two packed rows,
    equal t), scheduled so that every tile visits the higher block first:
    the earlier-visited block keeps the tie, so every hit lands on the
    higher row, as in the plain version. A fold by (t, row) across blocks
    would take the lower one."""
    scene, o, d = _random_scene(device, seed=tb + 30)
    rows = scene.v0.shape[0]
    scene = dataclasses.replace(scene, valid=scene.valid & (torch.arange(rows, device=device) < tb),
                                two_sided=torch.zeros_like(scene.two_sided))
    packed = tpi.pack_scene(scene, tri_block=tb)
    assert packed.w.shape[0] == 1
    twice = tpi.mark_live_slots(dataclasses.replace(packed, w=torch.cat([packed.w, packed.w]), live_slots_only=False))
    _, _, feats, alive = tpi.prepare_rays(o, d, packed)
    rt = feats.shape[0] // tpi.DEFAULT_RAY_TILE
    order = torch.tensor([[1, 0]], dtype=torch.int32, device=device).repeat(rt, 1)
    enter = torch.zeros((rt, 2), device=device)
    args = (order, enter, feats, alive, twice.w, tpi.DEFAULT_RAY_TILE)
    bt, bi = tpi.closest_hit(*args)
    rt_, ri = tpi.closest_hit_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(bi, ri) and torch.equal(bt, rt_)
    assert (ri >= 0).sum() > 50 and (ri[ri >= 0] >= tb).all()


@pytest.mark.parametrize("precision", ["high", "mixed"])
def test_mma_kernel_breaks_visit_order_ties_as_plain_version(device, precision):
    """The visit-order tie test above on K1's tensor-core route: duplicate
    blocks give every triangle two packed rows with equal t, the tile
    visits the higher block first, and every hit stays on the higher row,
    as in the plain version (the hit bar between them, and the same rows
    wherever the triangle agrees)."""
    tb = 128
    scene, o, d = _random_scene(device, seed=tb + 30)
    rows = scene.v0.shape[0]
    scene = dataclasses.replace(scene, valid=scene.valid & (torch.arange(rows, device=device) < tb),
                                two_sided=torch.zeros_like(scene.two_sided))
    packed = tpi.pack_scene(scene, tri_block=tb)
    twice = tpi.mark_live_slots(dataclasses.replace(packed, w=torch.cat([packed.w, packed.w]), live_slots_only=False))
    _, _, feats, alive = tpi.prepare_rays(o, d, packed)
    rt = feats.shape[0] // tpi.DEFAULT_RAY_TILE
    order = torch.tensor([[1, 0]], dtype=torch.int32, device=device).repeat(rt, 1)
    enter = torch.zeros((rt, 2), device=device)
    args = (order, enter, feats, alive, twice.w, tpi.DEFAULT_RAY_TILE)
    bt, bi = tpi.closest_hit(*args, precision=precision)
    rt_, ri = tpi.closest_hit_reference(*args, precision=precision)
    torch.cuda.synchronize()
    col = lambda rows: torch.where(rows >= 0, rows % tb, -1)  # both blocks hold the same triangle per column
    agree = col(bi) == col(ri)
    assert agree.double().mean().item() >= 0.9995
    assert torch.equal(bi[agree], ri[agree])
    torch.testing.assert_close(bt[agree], rt_[agree], rtol=1e-5, atol=1e-5)
    assert (ri >= 0).sum() > 50 and (ri[ri >= 0] >= tb).all() and (bi[bi >= 0] >= tb).all()


def test_resident_kernels_on_all_dead_tiles(device):
    """Whole tiles of dead lanes (and of maxt = 0 lanes) among live ones:
    they visit nothing and report -inf / -1 and 0, as the plain versions."""
    scene, o, d = _random_scene(device, seed=23)
    packed = tpi.pack_scene(scene, tri_block=128)
    tile = tpi.DEFAULT_RAY_TILE
    dead = torch.zeros(o.shape[0], dtype=torch.bool, device=device)
    dead[: 2 * tile] = True
    dead[10 * tile : 12 * tile] = True
    args = tpi.prepare_rays(o, d, packed, alive=~dead) + (packed.w, tile)
    bt, bi = tpi.closest_hit(*args)
    rt, ri = tpi.closest_hit_reference(*args)
    maxt = torch.full((o.shape[0],), 5.0, device=device).masked_fill(dead, 0.0)
    sargs = tpi.prepare_shadow_rays(o, d, maxt, packed) + (packed.w, tile)
    occ = tpi.occluded(*sargs)
    ref = tpi.occluded_reference(*sargs)
    torch.cuda.synchronize()
    assert torch.isinf(args[1][dead[::tile]]).all()  # the dead tiles schedule nothing
    assert torch.isneginf(bt[: o.shape[0]][dead]).all() and (bi[: o.shape[0]][dead] == -1).all()
    assert torch.equal(bi, ri) and (bi[: o.shape[0]][~dead] >= 0).any()
    assert (occ[: o.shape[0]][dead] == 0).all()
    assert torch.equal(occ, ref) and ref.sum() > 0


def test_occlusion_kernel_stops_after_first_block(device):
    """A large triangle in front of every ray and the rest of the scene far
    behind it: each tile's first scheduled block occludes all its lanes, so
    the bound falls to -inf and the plain version visits one block a tile;
    the kernel's flags equal it (all set)."""
    rng = np.random.default_rng(24)
    far = rng.normal(size=(300, 3, 3)).astype(np.float32) * 2 + np.array([0, 0, 25], np.float32)
    wall = np.array([[[-100, -100, 5], [0, 100, 5], [100, -100, 5]]], np.float32)  # faces -z: hit from z < 5
    v = np.concatenate([wall, far])
    mesh = MeshData(vertices=v, normals=np.zeros_like(v), uvs=np.zeros((v.shape[0], 3, 2), np.float32))
    scene = build_scene([mesh_spec(mesh)], [{"type": "diffuse"}], pad_to_multiple=128, device=device)
    packed = tpi.pack_scene(scene, tri_block=128)
    assert packed.w.shape[0] >= 3
    o = torch.as_tensor(np.concatenate([rng.uniform(-1, 1, (1024, 2)), np.zeros((1024, 1))], 1).astype(np.float32),
                        device=device)
    d = torch.nn.functional.normalize(
        torch.as_tensor(np.concatenate([rng.normal(size=(1024, 2)) * 0.2, np.ones((1024, 1))], 1).astype(np.float32),
                        device=device), dim=1)
    args = tpi.prepare_shadow_rays(o, d, torch.full((1024,), 100.0, device=device), packed) + (packed.w, 128)
    occ = tpi.occluded(*args)
    ref, work = tpi.occluded_reference(*args, count_work=True)
    torch.cuda.synchronize()
    assert work["blocks"] == 1024 // 128
    assert torch.equal(occ, ref) and bool((ref == 1).all())


def test_kernel_rejects_mixed_devices(device):
    scene, o, d = _random_scene(device)
    packed = tpi.pack_scene(scene, tri_block=128)
    order, enter, feats, alive = tpi.prepare_rays(o, d, packed)
    with pytest.raises(ValueError):
        tpi.closest_hit(order.cpu(), enter, feats, alive, packed.w)


NEE_SCENE = os.path.join(os.path.dirname(SCENE), "config8_icosphere.toml")


@pytest.mark.parametrize("estimator", ["nee", "mis"])
def test_nee_render_kernels_match_plain_version(device, estimator):
    scene, camera, settings = load_scene_file(NEE_SCENE, device=device)
    camera = dataclasses.replace(camera, width=64, height=64)
    settings = dataclasses.replace(settings, width=64, height=64, spp=2, estimator=estimator)
    tpi.closest_hit.launches = tpi.occluded.launches = 0
    got = render_frame(scene, camera, settings)
    assert tpi.closest_hit.launches == settings.spp * (settings.bounces + 1)
    assert tpi.occluded.launches == settings.spp * (settings.bounces - 1)
    want = render_frame(scene, camera, dataclasses.replace(settings, intersector="plucker"))
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert diff.mean().item() < 2e-3
    assert (diff.amax(dim=-1) > 3e-2).double().mean().item() < 5e-3


def test_render_kernel_matches_plain_version(device):
    scene, camera, settings = load_scene_file(SCENE, device=device)
    camera = dataclasses.replace(camera, width=64, height=64)
    settings = dataclasses.replace(settings, width=64, height=64, spp=2)
    before = tpi.closest_hit.launches
    got = render_frame(scene, camera, settings)
    assert tpi.closest_hit.launches == before + settings.spp * settings.bounces
    want = render_frame(scene, camera, dataclasses.replace(settings, intersector="plucker"))
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert diff.mean().item() < 2e-3
    assert (diff.amax(dim=-1) > 3e-2).double().mean().item() < 5e-3


# (tri_block, cluster bytes, ray tile): 1, 4 and every block per cluster,
# and 300 KB clusters of 256-wide blocks (bpc 3), at the main path's 64-ray
# tile; ragged chunks (tb 36 and 100: 9 and 25 float4 columns); the ray
# tiles 32 (one ray a thread), 128 and 1024 (one column group).
STREAM_SHAPES = [
    (128, 40 * 1024, 64), (128, 200 * 1024, 64), (64, 1 << 20, 64), (256, 300 * 1024, 64),
    (36, 60 * 1024, 64), (100, 100 * 1024, 64),
    (128, 100 * 1024, 32), (256, 300 * 1024, 128), (128, 100 * 1024, 1024),
]


@pytest.mark.parametrize("tb,cluster_bytes,ray_tile", STREAM_SHAPES)
def test_streamed_kernel_matches_plain_version(device, tb, cluster_bytes, ray_tile, monkeypatch):
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", cluster_bytes)
    scene, o, d = _random_scene(device, seed=tb + 7)
    packed = tpi.pack_scene(scene, tri_block=tb)
    alive = (torch.rand(o.shape[0], generator=torch.Generator().manual_seed(3)) < 0.8).to(device)
    args = tpi.prepare_rays_streamed(o, d, packed, alive=alive, ray_tile=ray_tile) + (ray_tile,)
    before = tpi.closest_hit_streamed.launches
    bt, bi = tpi.closest_hit_streamed(*args)
    assert tpi.closest_hit_streamed.launches == before + 1
    rt, ri = tpi.closest_hit_streamed_reference(*args)
    torch.cuda.synchronize()
    assert (bi == ri).double().mean().item() > 0.9995
    same = (bi == ri) & (ri >= 0)
    assert same.sum() > 100
    torch.testing.assert_close(bt[same], rt[same], rtol=1e-5, atol=1e-5)
    dead = args[4] == 0
    assert (bi[dead] == -1).all() and torch.isneginf(bt[dead]).all()


@pytest.mark.parametrize("tb,cluster_bytes,ray_tile", STREAM_SHAPES)
def test_streamed_occlusion_kernel_matches_plain_version(device, tb, cluster_bytes, ray_tile, monkeypatch):
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", cluster_bytes)
    scene, o, d = _random_scene(device, seed=tb + 8)
    packed = tpi.pack_scene(scene, tri_block=tb)
    hit = tpi.intersect_packed(o, d, packed)
    g = torch.Generator().manual_seed(4)
    scale = (0.5 + torch.rand(o.shape[0], generator=g)).to(device)
    maxt = torch.where(hit.hit, hit.t * scale, 20.0 * scale)
    maxt = torch.where(torch.rand(o.shape[0], generator=g).to(device) < 0.1, 0.0, maxt)
    args = tpi.prepare_shadow_rays_streamed(o, d, maxt, packed, ray_tile=ray_tile) + (ray_tile,)
    before = tpi.occluded_streamed.launches
    occ = tpi.occluded_streamed(*args)
    assert tpi.occluded_streamed.launches == before + 1
    ref = tpi.occluded_streamed_reference(*args)
    torch.cuda.synchronize()
    assert occ.dtype == torch.int32
    assert (occ == ref).double().mean().item() >= 0.9995
    assert 0.1 < ref.double().mean().item() < 0.9
    assert (occ[args[4] == 0] == 0).all()


@pytest.mark.parametrize("cluster_bytes", [1 << 20, 40 * 1024])
def test_streamed_kernel_breaks_duplicate_ties_as_plain_version(device, cluster_bytes, monkeypatch):
    """Every triangle packed twice (two identical one-sided meshes), so every
    hit ties two packed rows. Wherever the kernel and the plain version hit
    the same pair they take the same packed row; in one cluster (1 MB) that
    is the lower row of the pair, even where the pair straddles two blocks
    or two column groups."""
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", cluster_bytes)
    rng = np.random.default_rng(5)
    n = 600
    v = rng.normal(size=(n, 3, 3)).astype(np.float32) * 2
    mesh = MeshData(vertices=v, normals=np.zeros_like(v), uvs=np.zeros((n, 3, 2), np.float32))
    scene = build_scene([mesh_spec(mesh), mesh_spec(mesh)], [{"type": "diffuse"}], pad_to_multiple=128, device=device)
    o = torch.as_tensor(rng.normal(size=(4000, 3)).astype(np.float32) * 4, device=device)
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(4000, 3)).astype(np.float32), device=device), dim=1)
    packed = tpi.pack_scene(scene, tri_block=36)
    args = tpi.prepare_rays_streamed(o, d, packed) + (tpi.STREAM_RAY_TILE,)
    one_cluster = args[0].shape[1] == 1
    assert one_cluster == (cluster_bytes == 1 << 20)
    _, bi = tpi.closest_hit_streamed(*args)
    _, ri = tpi.closest_hit_streamed_reference(*args)
    torch.cuda.synchronize()
    pair = lambda rows: torch.where(rows >= 0, packed.tri_map[rows.long().clamp(min=0)] % n, -1)
    same_pair = (pair(bi) == pair(ri)) & (ri >= 0)
    assert same_pair.double().mean().item() > 0.9995 * (ri >= 0).double().mean().item()
    assert same_pair.sum() > 300
    assert torch.equal(bi[same_pair], ri[same_pair])
    if one_cluster:
        rows = torch.arange(packed.tri_map.shape[0], device=device)
        live = rows < 2 * n  # the live packed rows lead; their scene rows are the two meshes
        lower = torch.full((n,), 1 << 30, dtype=torch.long, device=device)
        lower.scatter_reduce_(0, packed.tri_map[live] % n, rows[live], reduce="amin")
        assert torch.equal(bi[same_pair].long(), lower[pair(bi)[same_pair]])


def test_streamed_kernels_on_all_dead_tiles(device, monkeypatch):
    """Whole tiles of dead lanes (and of maxt = 0 lanes) among live ones:
    they visit nothing and report -inf / -1 and 0, as the plain versions."""
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 100 * 1024)
    scene, o, d = _random_scene(device, seed=21)
    packed = tpi.pack_scene(scene, tri_block=128)
    tile = tpi.STREAM_RAY_TILE
    dead = torch.zeros(o.shape[0], dtype=torch.bool, device=device)
    dead[: 3 * tile] = True
    dead[10 * tile : 12 * tile] = True
    args = tpi.prepare_rays_streamed(o, d, packed, alive=~dead) + (tile,)
    bt, bi = tpi.closest_hit_streamed(*args)
    rt, ri = tpi.closest_hit_streamed_reference(*args)
    maxt = torch.full((o.shape[0],), 5.0, device=device).masked_fill(dead, 0.0)
    sargs = tpi.prepare_shadow_rays_streamed(o, d, maxt, packed) + (tile,)
    occ = tpi.occluded_streamed(*sargs)
    ref = tpi.occluded_streamed_reference(*sargs)
    torch.cuda.synchronize()
    assert (args[0][dead[::tile]] == args[0].shape[1]).all()  # the dead tiles schedule nothing
    assert torch.isneginf(bt[: o.shape[0]][dead]).all() and (bi[: o.shape[0]][dead] == -1).all()
    assert (bi == ri).double().mean().item() > 0.9995 and (bi[: o.shape[0]][~dead] >= 0).any()
    assert (occ[: o.shape[0]][dead] == 0).all()
    assert (occ == ref).double().mean().item() >= 0.9995 and ref.sum() > 0


def test_streamed_occlusion_stops_mid_cluster(device, monkeypatch):
    """One cluster of every block and long cutoffs: most lanes are occluded
    by some block in the middle of the cluster (the plain version's lane
    count falls short of visited blocks x live lanes) and the flags still
    equal the plain version's."""
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 1 << 20)
    scene, o, d = _random_scene(device, seed=22, rays=3008)  # whole tiles: no padded lane
    packed = tpi.pack_scene(scene, tri_block=64)
    maxt = torch.full((o.shape[0],), 100.0, device=device)
    args = tpi.prepare_shadow_rays_streamed(o, d, maxt, packed) + (tpi.STREAM_RAY_TILE,)
    assert args[0].shape[1] == 1  # one cluster
    occ = tpi.occluded_streamed(*args)
    ref, work = tpi.occluded_streamed_reference(*args, count_work=True)
    torch.cuda.synchronize()
    assert ref.double().mean().item() > 0.3
    assert work["lane_blocks"] < work["blocks"] * tpi.STREAM_RAY_TILE
    assert (occ == ref).double().mean().item() >= 0.9995


def _assert_launch_shapes_fit(libraries):
    for library in libraries:
        for ray_tile in range(32, 1025, 32):
            for precision in tpi.PRECISIONS:
                occ = tpi.launch_occupancy(library, ray_tile, precision)
                assert occ["threads"] <= 1024 and occ["ctas_per_sm"] >= 1, occ


def test_streamed_launch_shapes_fit_the_card(device):
    """Every ray tile the wrappers accept has a launch shape that the
    streamed kernels take at every precision (the bf16 modes on the
    tensor-core route), with at least one CTA resident per SM."""
    _assert_launch_shapes_fit(["closest_hit_streamed", "occlusion_streamed"])


def test_resident_launch_shapes_fit_the_card(device):
    """The same for the resident kernels K1 and K2."""
    _assert_launch_shapes_fit(["closest_hit", "occlusion"])


def _bench_loss_grads(scene, camera, settings):
    """Gradients of mean(image) in (v0, albedo); zeros where none reaches."""
    v0 = scene.v0.detach().clone().requires_grad_()
    albedo = scene.materials.albedo.detach().clone().requires_grad_()
    leaf = dataclasses.replace(scene, v0=v0, materials=dataclasses.replace(scene.materials, albedo=albedo))
    loss = render_frame(leaf, camera, settings).mean()
    grads = torch.autograd.grad(loss, (v0, albedo), allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, (v0, albedo))]


@pytest.mark.parametrize("config", ["config5", "config8"])
def test_gradients_through_kernels_match_plain_version(device, config):
    """The same hits, so the gradients of the bench loss through the kernels
    agree with those through the plain versions within rtol 1e-4, atol
    1e-6*max|g| (only the order of the scatter-adds backwards differs);
    config 8 runs K2 on its scan bounces."""
    if config == "config5":
        from gpupathtracer_tpu_torch.grad.inverse import _demo_setup

        settings, camera, make_scene, mesh = _demo_setup(width=48, height=48, spp=2, device=device)
        scene = make_scene(torch.tensor([0.5, 0.5, 0.5], device=device), torch.zeros(mesh.vertices.shape, device=device))
    else:
        path = os.path.join(os.path.dirname(SCENE), "config8_icosphere.toml")
        scene, camera, settings = load_scene_file(path, device=device)
        camera = dataclasses.replace(camera, width=64, height=64)
        settings = dataclasses.replace(settings, width=64, height=64, spp=2)
    before = (tpi.closest_hit.launches, tpi.occluded.launches)
    got = _bench_loss_grads(scene, camera, settings)
    assert tpi.closest_hit.launches > before[0]
    assert (tpi.occluded.launches > before[1]) == (config == "config8")
    want = _bench_loss_grads(scene, camera, dataclasses.replace(settings, intersector="plucker"))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and (w != 0).any()
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6 * w.abs().max().item())


def test_pack_refreshes_after_an_in_place_edit_on_the_card(device):
    """An in-place edit of v0, then a render, equals a render on a fresh
    pack, and differs from the render before the edit."""
    path = os.path.join(os.path.dirname(SCENE), "config5_invert_target.toml")
    scene, camera, settings = load_scene_file(path, device=device)
    camera = dataclasses.replace(camera, width=32, height=32)
    settings = dataclasses.replace(settings, width=32, height=32, spp=1)
    before = render_frame(scene, camera, settings)
    with torch.no_grad():
        scene.v0.add_(0.3)
    after = render_frame(scene, camera, settings)
    tpi._PACK_CACHE.clear()
    assert torch.equal(after, render_frame(scene, camera, settings))
    assert not torch.equal(after, before)


def _in_tile_dead_lanes(n, tile, device, seed):
    """Random dead lanes inside tiles (about half), plus two whole dead tiles."""
    g = torch.Generator().manual_seed(seed)
    dead = torch.rand(n, generator=g) < 0.5
    dead[2 * tile : 3 * tile] = True
    dead[7 * tile : 8 * tile] = True
    return dead.to(device)


@pytest.mark.parametrize("streamed", [False, True], ids=["K1", "K3"])
def test_closest_hit_kernels_exact_on_in_tile_dead_lanes(device, streamed, monkeypatch):
    """The mask-mode input: dead lanes between live ones in a tile, and
    all-dead tiles. Hits and t equal the plain version's exactly; dead lanes
    report -inf / -1."""
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 100 * 1024)
    scene, o, d = _random_scene(device, seed=40 + int(streamed), rays=4096)
    packed = tpi.pack_scene(scene, tri_block=128)
    tile = tpi.STREAM_RAY_TILE if streamed else tpi.DEFAULT_RAY_TILE
    dead = _in_tile_dead_lanes(o.shape[0], tile, device, seed=int(streamed))
    if streamed:
        args = tpi.prepare_rays_streamed(o, d, packed, alive=~dead) + (tile,)
        kernel, plain = tpi.closest_hit_streamed, tpi.closest_hit_streamed_reference
    else:
        args = tpi.prepare_rays(o, d, packed, alive=~dead) + (packed.w, tile)
        kernel, plain = tpi.closest_hit, tpi.closest_hit_reference
    bt, bi = kernel(*args)
    rt, ri = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bi, ri) and torch.equal(bt, rt)
    assert torch.isneginf(bt[: o.shape[0]][dead]).all() and (bi[: o.shape[0]][dead] == -1).all()
    assert (bi[: o.shape[0]][~dead] >= 0).sum() > 200


@pytest.mark.parametrize("streamed", [False, True], ids=["K2", "K4"])
def test_anyhit_kernels_exact_on_interleaved_zero_cutoffs(device, streamed, monkeypatch):
    """Uncompacted shadow rays, as mask mode casts them: max_t = 0 on random
    lanes between live ones. Flags equal the plain version's exactly and no
    max_t = 0 lane is occluded."""
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 100 * 1024)
    scene, o, d = _random_scene(device, seed=50 + int(streamed), rays=4096)
    packed = tpi.pack_scene(scene, tri_block=128)
    hit = tpi.intersect_packed(o, d, packed)
    scale = (0.5 + torch.rand(o.shape[0], generator=torch.Generator().manual_seed(6))).to(device)
    maxt = torch.where(hit.hit, hit.t * scale, 20.0 * scale)
    tile = tpi.STREAM_RAY_TILE if streamed else tpi.DEFAULT_RAY_TILE
    maxt = maxt.masked_fill(_in_tile_dead_lanes(o.shape[0], tile, device, seed=7), 0.0)
    if streamed:
        args = tpi.prepare_shadow_rays_streamed(o, d, maxt, packed) + (tile,)
        occ, ref = tpi.occluded_streamed(*args), tpi.occluded_streamed_reference(*args)
    else:
        args = tpi.prepare_shadow_rays(o, d, maxt, packed) + (packed.w, tile)
        occ, ref = tpi.occluded(*args), tpi.occluded_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(occ, ref) and 0.05 < ref.double().mean().item() < 0.9
    assert (occ[: o.shape[0]][maxt == 0] == 0).all()


def _image_bar(got, want):
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert diff.mean().item() < 2e-3
    assert (diff.amax(dim=-1) > 3e-2).double().mean().item() < 5e-3


@pytest.mark.parametrize("mode", ["mask", "hybrid"])
@pytest.mark.parametrize("change", [{}, {"estimator": "nee"}], ids=["naive", "nee"])
@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
def test_compact_mode_frames_meet_the_bar_against_permute(device, mode, change, streamed, monkeypatch):
    """Mask and hybrid frames through the kernels against the permute frame
    (the image bar; the CPU tests hold them equal to the bit). Streamed
    packs sort no rays here, so mask mode hands K3 and K4 dead lanes."""
    if streamed:
        monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
    scene, camera, settings = load_scene_file(NEE_SCENE, device=device)
    camera = dataclasses.replace(camera, width=96, height=96)
    settings = dataclasses.replace(settings, width=96, height=96, spp=2, sort_rays=False, **change)
    want = render_frame(scene, camera, settings)
    got = render_frame(scene, camera, dataclasses.replace(settings, compact_mode=mode))
    assert tpi.is_resident(tpi.pack_scene(scene, tri_block=settings.tri_block)) != streamed
    _image_bar(got, want)


GLASS_MIRROR = [{"type": "glass", "refractive_index": 1.5, "transmittance_color": (0.95, 0.97, 1.0)},
                {"type": "mirror", "specular_color": (0.9, 0.9, 0.9)},
                {"type": "emitter", "emissive_color": (1.0, 0.95, 0.9), "intensity": 6.0}]


@pytest.mark.parametrize("change", [{}, {"estimator": "nee"}, {"estimator": "mis"}, {"rr_start": 2}])
def test_glass_mirror_frame_kernels_match_plain_version(device, change):
    """The config 3 stand-in with a two-sided glass body and a mirror floor."""
    from gpupathtracer_tpu_torch.models.scene import plane_spec, sphere_spec

    specs = [dataclasses.replace(sphere_spec(radius=2.0, subdivisions=3), two_sided=True),
             plane_spec((0.0, -2.0, 0.0), (90.0, 0.0, 0.0), (20.0, 20.0, 20.0), mat_id=1),
             plane_spec((0.0, 6.0, 2.0), (60.0, 0.0, 0.0), (8.0, 8.0, 8.0), mat_id=2)]
    scene = build_scene(specs, GLASS_MIRROR, pad_to_multiple=128, device=device)
    _, camera, settings = load_scene_file(SCENE, device=device)
    camera = dataclasses.replace(camera, width=64, height=64)
    settings = dataclasses.replace(settings, width=64, height=64, spp=2, **change)
    before = tpi.closest_hit.launches
    got = render_frame(scene, camera, settings)
    assert tpi.closest_hit.launches > before
    want = render_frame(scene, camera, dataclasses.replace(settings, intersector="plucker"))
    assert want.mean().item() > 0.01
    _image_bar(got, want)


def test_cli_checkpointed_resume_on_the_card(device, tmp_path):
    """The CLI's progressive render on the card (chunks of 1 sample, a film
    checkpoint): the image equals the one-shot frame's; a film saved after 2
    of 4 samples and finished equals the uninterrupted progressive image."""
    from gpupathtracer_tpu_torch import cli
    from gpupathtracer_tpu_torch.render.film import to_u8
    from gpupathtracer_tpu_torch.render.progressive import render_progressive
    from gpupathtracer_tpu_torch.render.renderer import render_samples
    from gpupathtracer_tpu_torch.utils import checkpoint as ckpt
    from gpupathtracer_tpu_torch.utils.config import load_config
    from gpupathtracer_tpu_torch.utils.image import read_ppm

    cfg = load_config(SCENE)
    cfg["render"].update(width=64, height=64, spp=4)
    path = str(tmp_path / "scene.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    out, film = str(tmp_path / "x.ppm"), str(tmp_path / "film.npz")
    assert cli.main(["render", path, "--chunk-spp", "1", "--checkpoint", film, "--out", out]) == 0
    scene, camera, settings = load_scene_file(path, device=device)
    frame = render_frame(scene, camera, settings)
    np.testing.assert_array_equal(read_ppm(out), to_u8(frame))
    prog = render_progressive(scene, camera, settings, chunk_spp=1)
    torch.testing.assert_close(prog, frame.cpu(), rtol=0, atol=1e-6)
    resume = str(tmp_path / "resume.npz")
    ckpt.save_film(resume, render_samples(scene, camera, settings, 0, 2), 2, settings)
    assert torch.equal(render_progressive(scene, camera, settings, chunk_spp=1, checkpoint_path=resume), prog)


def test_threefry_draws_on_the_card_equal_the_cpu(device):
    """The threefry words are integer arithmetic, so the card's equal the
    CPU's bit for bit; uniforms too, and the categorical picks."""
    from gpupathtracer_tpu_torch.ops import sampling, threefry

    for seed in (0, 3, 1234):
        kc, kg = threefry.PRNGKey(seed), threefry.PRNGKey(seed, device=device)
        assert torch.equal(threefry.split(kg, 8).cpu(), threefry.split(kc, 8))
        assert torch.equal(threefry.fold_in(kg, 0x5EC2).cpu(), threefry.fold_in(kc, 0x5EC2))
        assert torch.equal(threefry.random_bits(kg, (64, 33), row_start=5).cpu(), threefry.random_bits(kc, (64, 33), row_start=5))
        assert torch.equal(threefry.uniform(kg, (4096, 2)).cpu(), threefry.uniform(kc, (4096, 2)))
        assert torch.equal(threefry.randint(kg, (4096,), 0, 640000).cpu(), threefry.randint(kc, (4096,), 0, 640000))
        logits = torch.log(torch.rand(3000, generator=torch.Generator().manual_seed(seed)))
        picks = threefry.categorical(kg, logits.to(device), shape=(1024,), row_chunk=256).cpu()
        assert torch.equal(picks, threefry.categorical(kc, logits, shape=(1024,)))
        ids = torch.arange(5000)
        tk = sampling.ThreefrySampler.path_keys((0, seed), ids.to(device), 3)
        assert torch.equal(tk.cpu(), sampling.ThreefrySampler.path_keys((0, seed), ids, 3))
        u = sampling.ThreefrySampler.uniform(sampling.ThreefrySampler.fold(tk, 7919), 3)
        assert torch.equal(u.cpu(), sampling.ThreefrySampler.uniform(sampling.ThreefrySampler.fold(tk.cpu(), 7919), 3))


def _edge_shadow_scene(device):
    """A floor under a light with a black occluder between (its scale s is
    the parameter) and a mirror: ``scene_fn(params)`` and the camera."""
    from gpupathtracer_tpu_torch.models.camera import Camera
    from gpupathtracer_tpu_torch.models.scene import GeometrySpec

    quad = torch.tensor([[[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0]],
                         [[-0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]]], device=device)
    materials = [{"type": "diffuse", "albedo": (0.6, 0.6, 0.6)},
                 {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 6.0},
                 {"type": "diffuse", "albedo": (0.0, 0.0, 0.0)},
                 {"type": "mirror", "specular_color": (0.9, 0.9, 0.9)}]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)

    def scene_fn(p):
        occ = GeometrySpec(vertices=quad * p["s"], normals=f32([[[0.0, 0.0, 1.0]] * 3] * 2), uvs=torch.zeros(2, 3, 2, device=device),
                           position=f32([0.0, 1.5, 0.0]), rotation_deg=f32([90.0, 0.0, 0.0]), scale=f32([1.0] * 3),
                           mat_id=2, two_sided=True)
        specs = [plane_spec((0.0, 0.0, 0.0), (90.0, 0.0, 0.0), (6.0, 6.0, 6.0), mat_id=0),
                 plane_spec((0.0, 3.0, 0.0), (90.0, 0.0, 0.0), (1.5, 1.5, 1.5), mat_id=1), occ,
                 plane_spec((1.8, 1.0, -0.5), (0.0, -40.0, 0.0), (2.0, 2.0, 1.0), mat_id=3)]
        return build_scene(specs, materials, pad_to_multiple=8, device=device)

    camera = Camera.create(position=(0.0, 1.0, 4.5), pitch=-25.0, fov_deg=50.0, width=48, height=48, device=device)
    return scene_fn, camera


def test_edge_gradient_through_kernels_matches_plain_version(device):
    """value_and_grad_with_edges (interior, primary and shadow terms, NEE,
    the mirror prefix, camera_fn) through the kernels against the plain
    versions, with the same key: the hits are the same, so the gradients
    agree within rtol 1e-4, atol 1e-6*max|g|."""
    from gpupathtracer_tpu_torch.grad import edges
    from gpupathtracer_tpu_torch.ops import threefry
    from gpupathtracer_tpu_torch.render.renderer import RenderSettings

    scene_fn, camera = _edge_shadow_scene(device)
    params = {"s": torch.tensor(1.0, device=device), "dx": torch.tensor(0.0, device=device)}
    cam_fn = lambda p: dataclasses.replace(camera, position=camera.position + torch.tensor([1.0, 0.0, 0.0], device=device) * p["dx"])
    table = edges.build_edge_table(scene_fn(params))
    settings = RenderSettings(width=48, height=48, spp=4, bounces=2, tri_block=8, estimator="nee", tri_block_secondary=32)
    out = {}
    for intersector in ("auto", "plucker"):
        before = tpi.closest_hit.launches
        loss, g = edges.value_and_grad_with_edges(
            torch.mean, scene_fn, params, camera, dataclasses.replace(settings, intersector=intersector), table,
            threefry.PRNGKey(7, device=device), n_samples=512, trace_spp=2, shadow_edges=True, shadow_samples=512,
            camera_fn=cam_fn, device=device,
        )
        assert (tpi.closest_hit.launches > before) == (intersector == "auto")
        out[intersector] = (loss, g)
    torch.testing.assert_close(out["auto"][0], out["plucker"][0], rtol=1e-6, atol=0)
    for k in params:
        got, want = out["auto"][1][k], out["plucker"][1][k]
        assert torch.isfinite(got) and want != 0, k
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * want.abs().item())


def test_hierarchical_picks_equal_on_card_and_cpu(device):
    """The cluster hierarchy's picks for one key are the same on the card
    and the CPU (the shading points, endpoints and bounds are the same
    tensors moved)."""
    from gpupathtracer_tpu_torch.grad import edges
    from gpupathtracer_tpu_torch.models.scene import sphere_spec
    from gpupathtracer_tpu_torch.ops import threefry

    scene = build_scene([sphere_spec(subdivisions=4), plane_spec((0.0, -1.5, 0.0), (90.0, 0.0, 0.0), (8.0, 8.0, 8.0))],
                        [{"type": "diffuse"}], pad_to_multiple=128, device="cpu")
    table = edges.build_edge_table(scene)
    clusters = edges.build_edge_clusters(scene, table, cluster_size=64)
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(512, 3)).astype(np.float32) * 3)
    tri1, corner = torch.as_tensor(table.tri1).long(), torch.as_tensor(table.corner).long()
    picks = {}
    for dev in ("cpu", device):
        s = scene.to(dev)
        va, vb = edges.edge_endpoints(s, tri1.to(dev), corner.to(dev))
        pick, q = edges._pick_edges_hierarchical(s, table, clusters, x.to(dev), va, vb, threefry.PRNGKey(11, device=dev))
        picks[str(dev)] = (pick.cpu(), q.cpu())
    (pc, qc), (pg, qg) = picks["cpu"], picks[str(device)]
    assert torch.equal(pg, pc)
    torch.testing.assert_close(qg, qc, rtol=1e-5, atol=0)


def assert_hit_bar(got, want, exact_t: bool = False):
    """The repo's hit bar between two Hits (ROADMAP's parity bar): at least
    99.95% of rays on the same triangle and, where they agree, t to rtol =
    atol = 1e-5; ``exact_t`` also asks t bit-equal there."""
    agree = got.tri == want.tri
    assert agree.double().mean().item() >= 0.9995
    same = agree & want.hit
    assert same.sum() > 100
    torch.testing.assert_close(got.t[same], want.t[same], rtol=1e-5, atol=1e-5)
    if exact_t:
        assert torch.equal(got.t[same], want.t[same])


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("precision", ["high", "mixed", "default"])
def test_kernels_match_plain_version_at_each_precision(device, precision, streamed, monkeypatch):
    """The closest-hit kernels K1 and K3 at a bf16 precision mode (the
    tensor-core route) against their plain versions at that mode: the hit
    bar, since a tensor core sums a k-step's exact bf16 products in an
    order of its own; "mixed" computes t as "highest" does, so its t is
    bit-equal wherever the triangle agrees."""
    if streamed:
        monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
        monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 100 * 1024)
    scene, o, d = _random_scene(device, seed=21)
    packed = tpi.pack_scene(scene, tri_block=128)
    alive = (torch.rand(o.shape[0], generator=torch.Generator().manual_seed(5)) < 0.8).to(device)
    search = tpi.closest_hit_streamed if streamed else tpi.closest_hit
    before = search.launches
    hk = tpi.intersect_packed(o, d, packed, alive=alive, precision=precision)
    assert search.launches == before + 1
    hp = tpi.intersect_packed(o, d, packed, alive=alive, precision=precision, plain=True)
    torch.cuda.synchronize()
    assert hp.hit.double().mean().item() > 0.2
    assert_hit_bar(hk, hp, exact_t=precision == "mixed")
    assert not hk.hit[~alive].any()


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("precision", ["high", "mixed", "default"])
def test_anyhit_kernels_match_plain_version_at_each_precision(device, precision, streamed, monkeypatch):
    """The any-hit kernels K2 and K4 at a bf16 precision mode (the
    tensor-core route) against their plain versions at that mode: the flag
    bar (at least 99.95% of flags equal, no maxt = 0 lane occluded), since
    a tensor core sums a k-step's exact bf16 products in an order of its
    own."""
    if streamed:
        monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
        monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 100 * 1024)
    scene, o, d = _random_scene(device, seed=21)
    packed = tpi.pack_scene(scene, tri_block=128)
    hp = tpi.intersect_packed(o, d, packed, precision=precision, plain=True)
    maxt = torch.where(hp.hit, hp.t * 1.5, 20.0)
    maxt = torch.where(torch.rand(o.shape[0], generator=torch.Generator().manual_seed(9)).to(device) < 0.1, 0.0, maxt)
    search = tpi.occluded_streamed if streamed else tpi.occluded
    before = search.launches
    ok = tpi.intersect_packed_occluded(o, d, maxt, packed, precision=precision)
    assert search.launches == before + 1
    op = tpi.intersect_packed_occluded(o, d, maxt, packed, precision=precision, plain=True)
    torch.cuda.synchronize()
    assert (ok == op).double().mean().item() >= 0.9995 and 0.1 < op.double().mean().item() < 0.95
    assert not ok[maxt == 0].any()


@pytest.mark.parametrize("precision", ["high", "mixed", "default"])
def test_mma_occlusion_kernel_stops_after_first_block(device, precision):
    """test_occlusion_kernel_stops_after_first_block at a bf16 mode (the
    tensor-core route): the wall in each tile's first scheduled block
    occludes every lane, the plain version visits one block a tile, and the
    kernel's flags equal it (all set)."""
    rng = np.random.default_rng(24)
    far = rng.normal(size=(300, 3, 3)).astype(np.float32) * 2 + np.array([0, 0, 25], np.float32)
    wall = np.array([[[-100, -100, 5], [0, 100, 5], [100, -100, 5]]], np.float32)  # faces -z: hit from z < 5
    v = np.concatenate([wall, far])
    mesh = MeshData(vertices=v, normals=np.zeros_like(v), uvs=np.zeros((v.shape[0], 3, 2), np.float32))
    scene = build_scene([mesh_spec(mesh)], [{"type": "diffuse"}], pad_to_multiple=128, device=device)
    packed = tpi.pack_scene(scene, tri_block=128)
    assert packed.w.shape[0] >= 3
    o = torch.as_tensor(np.concatenate([rng.uniform(-1, 1, (1024, 2)), np.zeros((1024, 1))], 1).astype(np.float32),
                        device=device)
    d = torch.nn.functional.normalize(
        torch.as_tensor(np.concatenate([rng.normal(size=(1024, 2)) * 0.2, np.ones((1024, 1))], 1).astype(np.float32),
                        device=device), dim=1)
    args = tpi.prepare_shadow_rays(o, d, torch.full((1024,), 100.0, device=device), packed) + (packed.w, 128)
    occ = tpi.occluded(*args, precision=precision)
    ref, work = tpi.occluded_reference(*args, count_work=True, precision=precision)
    torch.cuda.synchronize()
    assert work["blocks"] == 1024 // 128
    assert torch.equal(occ, ref) and bool((ref == 1).all())


@pytest.mark.parametrize("streamed", [False, True], ids=["K2", "K4"])
@pytest.mark.parametrize("precision", ["high", "mixed", "default"])
def test_mma_anyhit_kernels_at_two_m_tiles_a_warp(device, precision, streamed, monkeypatch):
    """K2 and K4 at a bf16 mode at a 1,024-ray tile, which takes two m-tiles
    of 16 rays a warp (one m-tile would need more threads than the launch
    bound), against their plain versions by the flag bar, with lanes at
    maxt = 0 among live ones."""
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 100 * 1024)
    scene, o, d = _random_scene(device, seed=26, rays=4096)
    packed = tpi.pack_scene(scene, tri_block=128)
    library = "occlusion_streamed" if streamed else "occlusion"
    assert tpi.launch_shape(library, 1024, precision)[2] == 2
    hit = tpi.intersect_packed(o, d, packed)
    scale = (0.5 + torch.rand(o.shape[0], generator=torch.Generator().manual_seed(10))).to(device)
    maxt = torch.where(hit.hit, hit.t * scale, 20.0 * scale)
    maxt = maxt.masked_fill(_in_tile_dead_lanes(o.shape[0], 1024, device, seed=11), 0.0)
    if streamed:
        args = tpi.prepare_shadow_rays_streamed(o, d, maxt, packed, ray_tile=1024) + (1024,)
        occ, ref = tpi.occluded_streamed(*args, precision=precision), tpi.occluded_streamed_reference(
            *args, precision=precision)
    else:
        args = tpi.prepare_shadow_rays(o, d, maxt, packed, ray_tile=1024) + (packed.w, 1024)
        occ, ref = tpi.occluded(*args, precision=precision), tpi.occluded_reference(*args, precision=precision)
    torch.cuda.synchronize()
    assert (occ == ref).double().mean().item() >= 0.9995 and 0.05 < ref.double().mean().item() < 0.9
    assert not occ[: o.shape[0]][maxt == 0].any()


@pytest.mark.parametrize("budget,subtiles", [(1, 1), (0, 4), (1, 2)])
def test_streamed_modes_kernel_at_mixed_matches_plain_version(device, budget, subtiles, monkeypatch):
    """K3's traversal-mode instantiation at "mixed" (the tensor-core route),
    seeded with a first budgeted call's partial hits, with a budget of 1
    and with sub-tiles, against its plain version: the hit bar on the
    hits, t bit-equal where the triangle agrees."""
    monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 100 * 1024)
    scene, o, d = _random_scene(device, seed=24)
    packed = tpi.pack_scene(scene, tri_block=64)
    alive = (torch.rand(o.shape[0], generator=torch.Generator().manual_seed(7)) < 0.8).to(device)
    args = tpi.prepare_rays_streamed(o, d, packed, alive=alive)
    init = tpi.closest_hit_streamed_reference(*args, precision="mixed", budget=1)
    modes = dict(init_t=init[0], init_i=init[1], budget=budget or None, subtiles=subtiles, precision="mixed")
    before = tpi.closest_hit_streamed.launches
    bt, bi = tpi.closest_hit_streamed(*args, **modes)
    assert tpi.closest_hit_streamed.launches == before + 1
    rt, ri = tpi.closest_hit_streamed_reference(*args, **modes)
    torch.cuda.synchronize()
    tri = lambda bi: torch.where(bi >= 0, packed.tri_map[bi.long().clamp(min=0)], -1)
    hit = lambda bt, bi: tpi.Hit(t=bt, tri=tri(bi), hit=bi >= 0)
    assert_hit_bar(hit(bt, bi), hit(rt, ri), exact_t=True)


@pytest.mark.parametrize("budget,subtiles,fresh", [(1, 1, False), (2, 4, False), (0, 2, False), (0, 1, True)])
def test_streamed_modes_kernel_matches_plain_version(device, budget, subtiles, fresh, monkeypatch):
    """K3's traversal-mode kernel, seeded with a first budgeted call's
    partial hits, against its plain version: the same best_t, best_i and
    done flags."""
    monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 100 * 1024)
    scene, o, d = _random_scene(device, seed=22)
    packed = tpi.pack_scene(scene, tri_block=64)
    alive = (torch.rand(o.shape[0], generator=torch.Generator().manual_seed(6)) < 0.8).to(device)
    args = tpi.prepare_rays_streamed(o, d, packed, alive=alive)
    init_t, init_i = tpi.closest_hit_streamed(*args, budget=1)
    modes = dict(init_t=init_t, init_i=init_i, budget=budget or None, subtiles=subtiles, fresh=fresh, with_done=True)
    before = tpi.closest_hit_streamed.launches
    got = tpi.closest_hit_streamed(*args, **modes)
    assert tpi.closest_hit_streamed.launches == before + 1
    want = tpi.closest_hit_streamed_reference(*args, **modes)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (want[1] >= 0).double().mean().item() > 0.2


def test_kernels_launch_on_offset_views_of_ray_inputs(device):
    """Only w must start on a 16-byte boundary: an int32 alive or a float32
    max_t that is a view one element into a larger tensor launches, with
    the results of the same values in a tensor of their own."""
    scene, o, d = _random_scene(device, seed=23)
    packed = tpi.pack_scene(scene, tri_block=128)
    order, enter, feats, alive = tpi.prepare_rays(o, d, packed)
    shifted = torch.cat([alive.new_zeros(1), alive])[1:]
    assert shifted.data_ptr() % 16 and torch.equal(shifted, alive)
    want = tpi.closest_hit(order, enter, feats, alive, packed.w)
    got = tpi.closest_hit(order, enter, feats, shifted, packed.w)
    max_t = torch.where(torch.arange(o.shape[0], device=device) % 3 == 0, 0.0, 6.0)
    order, enter, feats, maxt = tpi.prepare_shadow_rays(o, d, max_t, packed)
    shifted = torch.cat([maxt.new_zeros(1), maxt])[1:]
    assert shifted.data_ptr() % 16 and torch.equal(shifted, maxt)
    occ = tpi.occluded(order, enter, feats, maxt, packed.w)
    occ_shifted = tpi.occluded(order, enter, feats, shifted, packed.w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(occ_shifted, occ)
    assert (want[1] >= 0).any() and (occ > 0).any()


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("precision", ["highest", "high", "mixed", "default"])
@pytest.mark.parametrize("streamed", [False, True], ids=["K1", "K3"])
def test_test_counter_on_the_main_path_rays(device, streamed, precision):
    """K1 (config 3 stand-in) and K3 (config 6 stand-in) on chip_smoke's
    inputs, sample 0's camera rays on the first pack and its bounce-1 rays
    on the second: the test counter equals the plain version's
    lane_blocks x tb, and the hits with the counter are bit-equal to a
    launch with a null one."""
    import chip_smoke

    scene, camera, settings = load_scene_file(chip_smoke.STREAM_SCENE if streamed else chip_smoke.SCENE,
                                              device=device)
    packed = tpi.pack_scene(scene, tri_block=settings.tri_block)
    packed2 = tpi.pack_scene(scene, tri_block=settings.tri_block_secondary or settings.tri_block)
    assert tpi.is_resident(packed) != streamed
    prepare = tpi.prepare_rays_streamed if streamed else tpi.prepare_rays
    kernel = tpi.closest_hit_streamed if streamed else tpi.closest_hit
    plain = tpi.closest_hit_streamed_reference if streamed else tpi.closest_hit_reference
    ray_tile = tpi.STREAM_RAY_TILE if streamed else tpi.DEFAULT_RAY_TILE
    for (o, d), pack in zip(chip_smoke.main_path_rays(scene, camera, settings, packed), (packed, packed2)):
        args = prepare(o, d, pack) + (() if streamed else (pack.w,)) + (ray_tile,)
        tests = torch.zeros(1, dtype=torch.int64, device=device)
        bt, bi = kernel(*args, precision=precision, tests=tests)
        bt0, bi0 = kernel(*args, precision=precision)
        *_, work = plain(*args, precision=precision, count_work=True)
        torch.cuda.synchronize()
        assert torch.equal(_bits(bt), _bits(bt0)) and torch.equal(bi, bi0)
        assert int(tests.item()) == work["lane_blocks"] * pack.tri_block > 0


@pytest.mark.parametrize("budget,subtiles,fresh", [(1, 1, False), (2, 4, False), (0, 1, True)])
@pytest.mark.parametrize("precision", ["highest", "mixed"])
def test_streamed_modes_test_counter(device, budget, subtiles, fresh, precision, monkeypatch):
    """K3's traversal-mode kernel counts what its plain version counts (in
    the gated modes, the live lanes each block was computed for), and the
    counter changes no output."""
    monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 100 * 1024)
    scene, o, d = _random_scene(device, seed=25)
    packed = tpi.pack_scene(scene, tri_block=64)
    alive = (torch.rand(o.shape[0], generator=torch.Generator().manual_seed(8)) < 0.8).to(device)
    args = tpi.prepare_rays_streamed(o, d, packed, alive=alive)
    init_t, init_i = tpi.closest_hit_streamed_reference(*args, budget=1, precision=precision)
    modes = dict(init_t=init_t, init_i=init_i, budget=budget or None, subtiles=subtiles, fresh=fresh,
                 with_done=True, precision=precision)
    tests = torch.zeros(1, dtype=torch.int64, device=device)
    got = tpi.closest_hit_streamed(*args, tests=tests, **modes)
    bare = tpi.closest_hit_streamed(*args, **modes)
    *_, work = tpi.closest_hit_streamed_reference(*args, count_work=True, **modes)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[0]), _bits(bare[0])) and torch.equal(got[1], bare[1])
    assert torch.equal(got[2], bare[2])
    assert int(tests.item()) == work["lane_blocks"] * 64 > 0
