"""The search schedule's routes on the CPU: the rule that picks the kernel
(``packed_intersect.schedule_route``) on each of its conditions, CPU
searches and frames, and the plain versions' searches, that always take the
torch ops and record it in their ``render.schedule`` spans, ``prepare``'s
use of the kernel's outputs (the kernel replaced by a stand-in made of the
torch ops), the kernel op's registration, argument checks and sort scratch,
and the padded-pack cache. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import dataclasses
import gc
import os
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpupathtracer_tpu_torch.models.obj import MeshData
from gpupathtracer_tpu_torch.models.scene import build_scene, mesh_spec
from gpupathtracer_tpu_torch.ops import _build, schedule
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils.config import load_scene_file

SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes", "config3_icosphere.toml")
CUDA, CPU = torch.device("cuda"), torch.device("cpu")  # a device object needs no card
SHARED = schedule.SHARED_KEYS
KERNEL, OPS = tpi.SCHEDULE_ROUTES.index("kernel"), tpi.SCHEDULE_ROUTES.index("ops")

ROUTE_CASES = {
    "card": (CUDA, False, "kernel"),
    "cpu": (CPU, False, "ops"),
    "card, plain": (CUDA, True, "ops"),
    "cpu, plain": (CPU, True, "ops"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_schedule_route_on_each_condition(case):
    device, plain, want = ROUTE_CASES[case]
    assert tpi.schedule_route(device, plain) == want


def test_shared_key_bound_is_the_kernels():
    """The wrapper's bound on the keys a tile sorts in shared memory is the
    kernel's, and holds every pack of the benchmark's cells (at most ~410
    resident blocks, 107 streamed clusters a tile)."""
    with open(_build.source(_build.SCHEDULE)) as f:
        assert f"constexpr int SHARED_KEYS = {SHARED};" in f.read()
    assert SHARED >= 2048


def _scene(seed=0, n=600, rays=333):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3, 3)).astype(np.float32) * 2
    mesh = MeshData(vertices=v, normals=np.zeros_like(v), uvs=np.zeros((n, 3, 2), np.float32))
    scene = build_scene([mesh_spec(mesh)], [{"type": "diffuse"}], pad_to_multiple=128, device="cpu")
    o = torch.as_tensor(rng.normal(size=(rays, 3)).astype(np.float32) * 4)
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(rays, 3)).astype(np.float32)), dim=1)
    return scene, o, d


def _schedule_spans(prof):
    return [list(e.concrete_inputs) for e in prof.events() if e.name == "render.schedule"]


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
def test_cpu_searches_take_the_ops_route(streamed, monkeypatch):
    """A closest-hit and an any-hit search on CPU tensors never reach the
    kernel (also the straggler regroup's schedule), and every
    render.schedule span records the torch ops."""

    def refuse(*args, **kwargs):
        raise AssertionError("the schedule kernel ran on the CPU")

    monkeypatch.setattr(schedule, "tile_schedule", refuse)
    if streamed:
        monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
        monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 3 * tpi.K * tpi.NSCALARS * 64 * 4)
        monkeypatch.setattr(tpi, "STREAM_PHASE1_BUDGET", 1)
    scene, o, d = _scene(seed=3)
    packed = tpi.pack_scene(scene, tri_block=64)
    assert tpi.route(packed.w.shape[0], packed.tri_block).streamed == streamed
    alive = torch.arange(o.shape[0]) % 5 != 0
    before = _build.launch_counts[_build.SCHEDULE]
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        hit = tpi.intersect_packed(o, d, packed, alive=alive)
        occ = tpi.intersect_packed_occluded(o, d, torch.where(alive, 3.0, 0.0), packed)
    spans = _schedule_spans(prof)
    assert len(spans) >= 2 and all(s == [OPS] for s in spans)
    assert _build.launch_counts[_build.SCHEDULE] == before
    assert hit.hit.any() and occ.any()


def test_cpu_frames_take_the_ops_route(monkeypatch):
    """A naive frame on CPU tensors: every search's render.schedule span
    records the torch ops, and nothing is launched."""

    def refuse(*args, **kwargs):
        raise AssertionError("the schedule kernel ran on the CPU")

    monkeypatch.setattr(schedule, "tile_schedule", refuse)
    scene, camera, settings = load_scene_file(SCENE, device="cpu")
    camera = dataclasses.replace(camera, width=12, height=12)
    settings = dataclasses.replace(settings, width=12, height=12, spp=2)
    before = _build.launch_counts[_build.SCHEDULE]
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        img = render_frame(scene, camera, settings, device="cpu")
    spans = _schedule_spans(prof)
    assert len(spans) == settings.spp * settings.bounces
    assert all(s == [OPS] for s in spans)
    assert _build.launch_counts[_build.SCHEDULE] == before
    assert torch.isfinite(img).all()


def _stand_in(o, d, lanes, packed, bpc, ray_tile, any_hit=False, rays=True):
    """The kernel's outputs made by the torch ops, as ``schedule.tile_schedule``
    returns them."""
    r = o.shape[0]
    pad = (-r) % ray_tile
    o_p = torch.cat([o, o.new_zeros((pad, 3))])
    d_p = torch.cat([d, d.new_ones((pad, 3))])
    if lanes is None:
        lanes = torch.ones((r,), dtype=torch.int32)
    lanes = torch.cat([lanes.to(torch.float32 if any_hit else torch.int32), lanes.new_zeros((pad,), dtype=(
        torch.float32 if any_hit else torch.int32))])
    mask, enter = tpi.tile_block_mask(o_p, d_p, packed, ray_tile, alive=lanes > 0)
    if bpc:
        sched = tpi.cluster_schedule(mask, enter, bpc)
    else:
        sched = tpi.plan_block_order(mask, enter) + (torch.empty(0),)
    feats = torch.cat([tpi.pack_rays(o, d), torch.zeros((pad, tpi.K))])
    if not rays:
        feats, lanes = torch.empty((0, tpi.K)), torch.empty(0)
    empty = torch.empty((0, 3))
    return (*sched, feats, lanes, o_p if pad and rays else empty, d_p if pad and rays else empty)


KERNEL_CASES = {
    "resident, every lane live": (False, "all", 384),
    "resident, alive with padding": (False, "alive", 333),
    "resident, cutoffs with zeros": (False, "cutoff", 333),
    "streamed, alive": (True, "alive", 333),
    "streamed, cutoffs with padding": (True, "cutoff", 250),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_prepare_on_the_kernel_route(case, monkeypatch):
    """Where the rule picks the kernel, ``prepare`` takes every input but w
    from its one call (here a stand-in of torch ops): the same inputs as
    the torch-op route, in a span that records the kernel, with the
    lanes, ``bpc``, ``ray_tile`` and ``any_hit`` the route implies."""
    streamed, lanes_kind, rays = KERNEL_CASES[case]
    calls = []

    def stand_in(*args, **kwargs):
        calls.append((args[4:], kwargs))
        return _stand_in(*args, **kwargs)

    scene, o, d = _scene(seed=5, rays=rays)
    packed = tpi.pack_scene(scene, tri_block=64)
    nb = packed.w.shape[0]
    way = tpi.Route(True, 3, 64) if streamed else tpi.Route(False, 0, 128)
    lanes = {"all": None, "alive": torch.arange(rays) % 7 != 0,
             "cutoff": torch.where(torch.arange(rays) % 3 == 0, 0.0, 5.0)}[lanes_kind]
    any_hit = lanes_kind == "cutoff"
    want = tpi.prepare(o, d, lanes, packed, way, any_hit=any_hit)
    rule = tpi.schedule_route
    monkeypatch.setattr(tpi, "schedule_route", lambda device, plain=False: rule(CUDA, plain))
    monkeypatch.setattr(schedule, "tile_schedule", stand_in)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        got = tpi.prepare(o, d, lanes, packed, way, any_hit=any_hit)
    assert _schedule_spans(prof) == [[KERNEL]]
    assert calls == [((way.bpc if streamed else 0, way.ray_tile, any_hit), {})]
    assert got[2].w.shape[0] == (-(-nb // 3) * 3 if streamed else nb)
    for a, b in zip(got[:2] + got[3], want[:2] + want[3]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
def test_plain_searches_take_the_ops_route(streamed, monkeypatch):
    """With ``plain=True`` the searches' schedules take the torch ops where
    the rule would give the rays the kernel (the regroup's schedule too), and
    without it the kernel: the plain versions hold the kernel's schedule to
    the torch ops'."""
    calls = []

    def stand_in(*args, **kwargs):
        calls.append(args[4:])
        return _stand_in(*args, **kwargs)

    if streamed:
        monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
        monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 3 * tpi.K * tpi.NSCALARS * 64 * 4)
        monkeypatch.setattr(tpi, "STREAM_PHASE1_BUDGET", 1)
    rule = tpi.schedule_route
    monkeypatch.setattr(tpi, "schedule_route", lambda device, plain=False: rule(CUDA, plain))
    monkeypatch.setattr(schedule, "tile_schedule", stand_in)
    scene, o, d = _scene(seed=6)
    packed = tpi.pack_scene(scene, tri_block=64)
    alive = torch.arange(o.shape[0]) % 5 != 0
    max_t = torch.where(alive, 3.0, 0.0)
    runs = {}
    for plain in (True, False):
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            hit = tpi.intersect_packed(o, d, packed, alive=alive, plain=plain)
            occ = tpi.intersect_packed_occluded(o, d, max_t, packed, plain=plain)
        runs[plain] = (_schedule_spans(prof), len(calls), hit, occ)
    spans, n, hit, occ = runs[True]
    assert n == 0 and len(spans) == (3 if streamed else 2) and all(s == [OPS] for s in spans)
    spans, n, hit2, occ2 = runs[False]
    assert n == len(spans) == (3 if streamed else 2) and all(s == [KERNEL] for s in spans)
    assert torch.equal(hit.tri, hit2.tri) and torch.equal(hit.t, hit2.t) and torch.equal(occ, occ2)
    assert hit.hit.any() and occ.any()


def test_schedule_op_takes_card_tensors_only():
    """The launch is a dispatcher op with a CUDA kernel alone, so the
    profiler links it to the caller's render.schedule span."""
    op = "firefly_schedule::prepare"
    assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(op, "CPU")
    assert schedule._prepare_kernel is torch.ops.firefly_schedule.prepare.default


def _launch_args(r=200, nb=12):
    return dict(o=torch.zeros(r, 3), d=torch.ones(r, 3), lanes=torch.ones(r, dtype=torch.bool),
                box_lo=torch.zeros(nb, 3), box_hi=torch.ones(nb, 3), block_live=torch.ones(nb, dtype=torch.bool),
                bpc=0, ray_tile=64, any_hit=False, rays=True)


BAD = {
    "o with rows 6 floats apart": lambda a: {"o": torch.zeros(200, 6)[:, :3]},
    "float64 o": lambda a: {"o": a["o"].double()},
    "d of another length": lambda a: {"d": torch.ones(201, 3)},
    "d not contiguous": lambda a: {"d": torch.ones(3, 200).t()},
    "int64 alive": lambda a: {"lanes": a["lanes"].long()},
    "alive of another length": lambda a: {"lanes": torch.ones(199, dtype=torch.bool)},
    "int32 cutoffs": lambda a: {"lanes": torch.ones(200, dtype=torch.int32), "any_hit": True},
    "no cutoffs": lambda a: {"lanes": None, "any_hit": True},
    "boxes of 2 axes": lambda a: {"box_lo": torch.zeros(12, 2)},
    "box_hi of another length": lambda a: {"box_hi": torch.ones(11, 3)},
    "int block_live": lambda a: {"block_live": torch.ones(12, dtype=torch.int32)},
    "blocks not whole clusters": lambda a: {"bpc": 5},
    "no blocks": lambda a: {"box_lo": torch.zeros(0, 3), "box_hi": torch.ones(0, 3),
                            "block_live": torch.ones(0, dtype=torch.bool)},
    "no ray tile": lambda a: {"ray_tile": 0},
}


@pytest.mark.parametrize("case", list(BAD))
def test_schedule_kernel_refuses_what_it_does_not_take(case):
    """The wrapper raises ValueError before it builds or launches anything
    (so on the CPU too) on inputs of another dtype, shape or layout."""
    args = _launch_args()
    args.update(BAD[case](args))
    before = _build.launch_counts[_build.SCHEDULE]
    with pytest.raises(ValueError):
        schedule._prepare_launch(**args)
    assert _build.launch_counts[_build.SCHEDULE] == before


def test_schedule_kernel_refuses_tensors_on_two_devices():
    args = _launch_args()
    args["box_lo"] = torch.zeros((12, 3), device="meta")
    with pytest.raises(ValueError, match="every tensor"):
        schedule._prepare_launch(**args)


@pytest.mark.parametrize("keys", [SHARED, SHARED + 1], ids=["in_shared_memory", "past_shared_memory"])
def test_schedule_sort_takes_any_key_count(keys, monkeypatch):
    """A tile of at most SHARED_KEYS keys sorts in shared memory (no
    scratch); one of more sorts in a global scratch the wrapper allocates:
    a power-of-two count of 8-byte pairs and a key each, a tile."""
    launched = []
    monkeypatch.setattr(_build, "launch", lambda *args: launched.append(args))
    args = _launch_args(r=200, nb=keys)
    schedule._prepare_launch(**args)
    (call,) = launched
    scratch, rt = call[18], -(-200 // args["ray_tile"])
    assert call[22:] == (keys, 1)
    if keys <= SHARED:
        assert scratch is None
    else:
        sort_n = 1 << (keys - 1).bit_length()
        assert scratch.dtype == torch.uint8 and scratch.shape == (rt * (8 * sort_n + 4 * keys),)


def test_padded_pack_is_made_once_per_pack():
    """Every streamed search of a pack reuses one padded pack; an in-place
    edit of its boxes, or another ``bpc``, makes it anew."""
    scene, _, _ = _scene(seed=7)
    packed = tpi.pack_scene(scene, tri_block=64)
    bpc = packed.w.shape[0] + 1
    first = tpi._pad_blocks(packed, bpc)
    assert tpi._pad_blocks(packed, bpc) is first and first.w.shape[0] == bpc
    packed.box_hi.add_(0.0)
    again = tpi._pad_blocks(packed, bpc)
    assert again is not first and torch.equal(again.box_hi, first.box_hi) and torch.equal(again.w, first.w)
    assert tpi._pad_blocks(packed, bpc + 1).w.shape[0] == bpc + 1


def test_padded_pack_is_freed_with_its_pack():
    """The padded pack is cached on the source pack's ``w``, so it lives no
    longer than the pack (here a copy, which no pack cache holds)."""
    scene, _, _ = _scene(seed=8)
    packed = tpi.pack_scene(scene, tri_block=64)
    packed = dataclasses.replace(packed, w=packed.w.clone())
    bpc = packed.w.shape[0] + 1
    padded = weakref.ref(tpi._pad_blocks(packed, bpc).w)
    assert tpi._pad_blocks(packed, bpc).w is padded()
    del packed
    gc.collect()
    assert padded() is None
