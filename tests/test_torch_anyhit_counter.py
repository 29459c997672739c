"""The traced frame's any-hit test counter and the render.nee span on the
CPU (the streamed any-hit search's plain version counts what its
``count_work`` counts), and the benchmark's readers of them:
``k4_roofline_pct``, ``anyhit_useful_pct`` and ``nee_device_ms``
(``h100_bench/metrics/``), on hand-built runs and on a program without
these records.

Imports no JAX."""

import dataclasses
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils import profiling
from gpupathtracer_tpu_torch.utils.config import load_scene_file
from h100_bench import devtrace, drive, roofline, spec
from h100_bench.reference.trace import BounceStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("k4_roofline_pct.render", "anyhit_useful_pct.render", "nee_device_ms.render")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The c6-nee configuration at 16x16 on a subdivision-2 sphere."""
    with open(os.path.join(REPO, "h100_bench", "configs", "config6_nee.json")) as f:
        cfg = json.load(f)
    cfg["render"]["width"] = cfg["render"]["height"] = 16
    cfg["geometry"][0]["subdivisions"] = 2
    path = tmp_path_factory.mktemp("anyhit") / "c6nee.json"
    path.write_text(json.dumps(cfg))
    scene, camera, settings = load_scene_file(str(path), device="cpu")
    return scene, camera, dataclasses.replace(settings, spp=2)


@pytest.fixture
def streamed(monkeypatch):
    monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 16 * 1024)


def test_anyhit_counter_equals_the_plain_versions_count(small, streamed, monkeypatch):
    """A traced NEE frame's any-hit counter is the sum over its streamed
    any-hit searches of the plain version's lane_blocks x tb on the same
    inputs; the closest-hit counter keeps only the closest-hit searches'."""
    calls = []
    search = tpi.occluded_streamed

    def spy(*args, **kwargs):
        calls.append((args, kwargs["precision"]))
        return search(*args, **kwargs)

    monkeypatch.setattr(tpi, "occluded_streamed", spy)
    scene, camera, settings = small
    with profile(activities=[ProfilerActivity.CPU]):
        render_frame(scene, camera, settings, seed=9, device="cpu")
    record = profiling.frame_records()[-1]
    assert len(calls) == settings.spp * (settings.bounces - 1)
    want = 0
    for args, precision in calls:
        _, work = tpi.occluded_streamed_reference(*args, precision=precision, count_work=True)
        want += work["lane_blocks"] * (args[5].shape[2] // 5)
    assert record["anyhit_tests"] == want > 0
    assert record["tests"] > 0
    render_frame(scene, camera, settings, seed=10, device="cpu")
    last = profiling.frame_records()[-1]
    assert last["seed"] == 10 and last["tests"] is None and last["anyhit_tests"] is None
    assert profiling.frame_anyhit_tests() is None


def test_plain_any_hit_search_adds_its_count_to_a_counter():
    g = torch.Generator().manual_seed(1)
    tris = torch.rand(600, 3, 3, generator=g) * 4 - 2
    from gpupathtracer_tpu_torch.models.obj import MeshData
    from gpupathtracer_tpu_torch.models.scene import build_scene, mesh_spec

    mesh = MeshData(vertices=tris.numpy(), normals=torch.zeros_like(tris).numpy(),
                    uvs=torch.zeros(600, 3, 2).numpy())
    scene = build_scene([mesh_spec(mesh, two_sided=True)], [{"type": "diffuse"}], pad_to_multiple=64, device="cpu")
    packed = tpi.pack_scene(scene, tri_block=64)
    o = torch.rand(500, 3, generator=g) * 8 - 4
    d = torch.nn.functional.normalize(torch.randn(500, 3, generator=g), dim=-1)
    maxt = torch.rand(500, generator=g) * 6
    maxt[::7] = 0.0
    args = tpi.prepare_shadow_rays_streamed(o, d, maxt, packed)
    tests = torch.zeros(1, dtype=torch.int64)
    occ = tpi.occluded_streamed(*args, tests=tests)
    ref, work = tpi.occluded_streamed_reference(*args, count_work=True)
    assert torch.equal(occ, ref) and 0 < ref.sum() < (maxt > 0).sum()
    assert int(tests.item()) == work["lane_blocks"] * 64 > 0
    with pytest.raises(ValueError, match="tests must be int64"):
        tpi.occluded_streamed(*args, tests=torch.zeros(2, dtype=torch.int64))


def _run(work, anyhit=None, spans=None, k4_s=0.004, items=1):
    """A drive.Run of two frames, the second traced, with a hand-built trace
    and program records of the traced frame."""
    run = drive.Run(loop="nee_frames", setup_s=1.0, starts=[1.0, 2.0], ends=[1.5, 2.5], rays_per_item=1,
                    pixels=256, spp=2, triangles=1000)
    by_name = {"void occlusion_streamed_kernel<false>(int)": k4_s, "other": 0.001}
    run.trace = devtrace.Trace(wall_s=0.5, items=items, busy_s=0.01, device_ops=40, device_s=0.02, by_name=by_name,
                               span_device_s=spans or {}, idle_by_host=[])
    run.traced, run.work = range(1, 2), work
    return run


def test_readers_of_the_nee_cell(monkeypatch):
    work = [BounceStats(lanes=256, live=256, counted=64, tests=100),
            BounceStats(lanes=256, live=128, counted=64, tests=90),
            BounceStats(lanes=256, live=64, counted=64, tests=80),
            BounceStats(lanes=256, live=0)]
    for st, (live, counted, tests) in zip(work, [(100, 64, 500), (64, 32, 96), (16, 16, 40), (0, 0, 0)]):
        st.shadow_live, st.shadow_counted, st.shadow_tests = live, counted, tests
    records = [{"seed": 1, "start_s": 2.1, "end_s": 2.4, "tests": 5000, "anyhit_tests": 400}]
    monkeypatch.setattr(profiling, "frame_records", lambda: records)
    run = _run(work, spans={"render.nee": 0.003, "render.shade": 0.005})
    read = {name: spec.reader(REPO, name) for name in READERS}
    # Bounce 0's shadow rays are K3's; bounces 1 and 2 cast K4's: 256 x 64 /
    # 256 = 64 rays of 96 / 32 tests each, 16 rays of 40 / 16.
    need = 2 * (64 * 96 / 32 + 16 * 40 / 16)
    assert read["anyhit_useful_pct.render"](run) == pytest.approx(100.0 * need / 400)
    bound = 2 * (roofline.bound_s(64, 64 * 3, 1000, 5) + roofline.bound_s(16, 16 * 2.5, 1000, 5))
    assert read["k4_roofline_pct.render"](run) == pytest.approx(100.0 * bound / 0.004)
    assert read["nee_device_ms.render"](run) == pytest.approx(3.0)
    # No trace, no device operation, no work counted, no K4 launch, no span:
    # nothing to read, and no reader raises.
    untraced = _run(work)
    untraced.trace = None
    for name, fn in read.items():
        assert fn(untraced) is None, name
    assert read["k4_roofline_pct.render"](_run(work, k4_s=0.0)) is None
    assert read["nee_device_ms.render"](_run(work)) is None
    bare = [BounceStats(lanes=256, live=256, counted=64, tests=100) for _ in range(4)]
    assert read["k4_roofline_pct.render"](_run(bare)) is None
    assert read["anyhit_useful_pct.render"](_run(bare)) is None


def test_readers_find_nothing_in_a_program_without_the_records(monkeypatch):
    """The parent's program has no any-hit counter in its records (or no
    records at all) and no render.nee span: the readers that need them
    return None; k4_roofline_pct reads the kernel by name and the
    reference's work, which both sides have."""
    st = BounceStats(lanes=4, live=4, counted=4, tests=4)
    st.shadow_live, st.shadow_counted, st.shadow_tests = 4, 4, 4
    run = _run([st, st])
    monkeypatch.setattr(profiling, "frame_records",
                        lambda: [{"seed": 1, "start_s": 2.1, "end_s": 2.4, "tests": 5000}])
    assert spec.reader(REPO, "anyhit_useful_pct.render")(run) is None
    monkeypatch.delattr(profiling, "frame_records")
    assert spec.reader(REPO, "anyhit_useful_pct.render")(run) is None
    assert spec.reader(REPO, "nee_device_ms.render")(run) is None
    assert spec.reader(REPO, "k4_roofline_pct.render")(run) > 0
