"""The port's tracing on the CPU: the render path's spans under
``torch.profiler`` (names, nesting, the frame's seed) on both search
routes, nothing opened or allocated without a profiler, the frame records'
ring, the closest-hit test counter against the plain versions' count, and
the benchmark's readers of these spans and records (``h100_bench/``).

Imports no JAX."""

import dataclasses
import json
import os
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils import profiling
from gpupathtracer_tpu_torch.utils.config import load_scene_file
from h100_bench import devtrace, drive, spec
from h100_bench.reference.trace import BounceStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = ("render.frame", "render.bounce", "render.compact", "render.schedule", "render.search.closest",
         "render.shade", "render.rng")
# (span, the innermost render.* span around it) of a naive frame.
NESTING = {("render.frame", None), ("render.bounce", "render.frame"), ("render.rng", "render.frame"),
           ("render.compact", "render.bounce"), ("render.schedule", "render.bounce"),
           ("render.search.closest", "render.bounce"), ("render.shade", "render.bounce"),
           ("render.rng", "render.shade")}
ROUTES = ["resident", "streamed", "streamed_modes"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The config 3 stand-in of the benchmark at 16x16 and spp 2, on a
    subdivision-2 sphere: a resident pack at tb 128, a second at 512."""
    with open(os.path.join(REPO, "h100_bench", "configs", "config3_icosphere.json")) as f:
        cfg = json.load(f)
    cfg["render"]["width"] = cfg["render"]["height"] = 16
    cfg["geometry"][0]["subdivisions"] = 2
    path = tmp_path_factory.mktemp("tracing") / "c3.json"
    path.write_text(json.dumps(cfg))
    scene, camera, settings = load_scene_file(str(path), device="cpu")
    return scene, camera, dataclasses.replace(settings, spp=2)


def _route(monkeypatch, route):
    if route != "resident":
        monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 1024)
        monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 16 * 1024)
    if route == "streamed_modes":  # budgeted first phase, the straggler regroup, sub-tile gates
        monkeypatch.setattr(tpi, "STREAM_PHASE1_BUDGET", 1)
        monkeypatch.setattr(tpi, "STREAM_SUBTILES", 4)


def _traced_frame(small, seed):
    scene, camera, settings = small
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        render_frame(scene, camera, settings, seed=seed, device="cpu")
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith("render.")]


def _parent(e, spans):
    """The name of the innermost other span around ``e``, or None."""
    around = [f for f in spans if f is not e and f.start_ns() <= e.start_ns()
              and e.start_ns() + e.duration_ns() <= f.start_ns() + f.duration_ns()]
    return min(around, key=lambda f: f.duration_ns()).name() if around else None


@pytest.mark.parametrize("route", ROUTES[:2])
def test_traced_frame_records_the_spans_with_their_nesting_and_seed(small, route, monkeypatch):
    _route(monkeypatch, route)
    seed = 2 ** 31 + 77
    spans = _traced_frame(small, seed)
    counts = Counter(e.name() for e in spans)
    settings = small[2]
    assert set(counts) == set(SPANS)
    assert all(e.is_user_annotation() for e in spans)
    assert counts["render.frame"] == 1
    searches = settings.spp * settings.bounces
    assert counts["render.bounce"] == counts["render.schedule"] == counts["render.search.closest"] == searches
    assert counts["render.shade"] == searches
    # A compaction before and the inverse permutation after each later bounce's search.
    assert counts["render.compact"] == 2 * settings.spp * (settings.bounces - 1)
    assert {(e.name(), _parent(e, spans)) for e in spans} == NESTING
    frame = next(e for e in spans if e.name() == "render.frame")
    assert frame.concrete_inputs() == [seed]


def test_nee_shadow_rays_search_any_in_shade(small):
    scene, camera, settings = small
    settings = dataclasses.replace(settings, estimator="nee", spp=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_frame(scene, camera, settings, seed=3, device="cpu")
    spans = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("render.")]
    anyhit = [e for e in spans if e.name() == "render.search.any"]
    nee = [e for e in spans if e.name() == "render.nee"]
    # Bounce 0 thresholds a closest hit; the later bounces search the second pack.
    assert len(anyhit) == settings.bounces - 1
    # Every bounce samples a light inside its shade span, the shadow rays'
    # search inside that.
    assert len(nee) == settings.bounces
    assert {_parent(e, spans) for e in anyhit} == {"render.nee"}
    assert {_parent(e, spans) for e in nee} == {"render.shade"}


def test_untraced_frame_opens_no_span_and_allocates_no_counter(small, monkeypatch):
    opened, seen = [], []
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", lambda *a: opened.append(a))
    search = tpi.closest_hit

    def spy(*args, **kwargs):
        seen.append(kwargs["tests"])
        return search(*args, **kwargs)

    monkeypatch.setattr(tpi, "closest_hit", spy)
    scene, camera, settings = small
    untraced = lambda: sum(r["tests"] is None for r in profiling.frame_records())
    before = untraced()
    render_frame(scene, camera, settings, seed=11, device="cpu")
    assert not profiling.tracing() and opened == []
    assert len(seen) == settings.spp * settings.bounces and all(t is None for t in seen)
    assert untraced() == min(before + 1, profiling.FRAME_RING)
    last = profiling.frame_records()[-1]
    assert last["seed"] == 11 and last["tests"] is None and last["start_s"] < last["end_s"]
    assert profiling.frame_tests() is None


def test_the_frame_rings_keep_the_newest_frames_of_each_kind():
    """A traced frame's record outlives the untraced frames after it: the
    benchmark's traced items come early in a window of hundreds."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.frame(-1, "cpu"):
            pass
    for seed in range(profiling.FRAME_RING + 44):
        with profiling.frame(seed, "cpu"):
            pass
    records = profiling.frame_records()
    untraced = [r["seed"] for r in records if r["tests"] is None]
    assert untraced == list(range(44, profiling.FRAME_RING + 44))
    traced = [r for r in records if r["tests"] is not None]
    assert traced[-1]["seed"] == -1 and traced[-1]["tests"] == 0
    assert records.index(traced[-1]) < records.index(next(r for r in records if r["seed"] == 44))


@pytest.mark.parametrize("route", ROUTES)
def test_test_counter_equals_the_plain_versions_count(small, route, monkeypatch):
    """The traced frame's counter is the sum over its closest-hit searches
    of the plain version's lane_blocks x tb on the same inputs."""
    _route(monkeypatch, route)
    calls = []
    for name in ("closest_hit", "closest_hit_streamed"):
        search = getattr(tpi, name)

        def spy(*args, _search=search, _name=name, **kwargs):
            calls.append((_name, args, {k: v for k, v in kwargs.items() if k != "tests"}))
            return _search(*args, **kwargs)

        monkeypatch.setattr(tpi, name, spy)
    _traced_frame(small, seed=5)
    got = profiling.frame_records()[-1]["tests"]
    want = 0
    for name, args, kwargs in calls:
        plain = tpi.closest_hit_reference if name == "closest_hit" else tpi.closest_hit_streamed_reference
        w = args[4] if name == "closest_hit" else args[5]
        work = plain(*args, count_work=True, **kwargs)[-1]
        want += work["lane_blocks"] * (w.shape[2] // 5)
    settings = small[2]
    streamed = route != "resident"
    assert {n for n, _, _ in calls} == {"closest_hit_streamed" if streamed else "closest_hit"}
    # The modes route also resumes its undone lanes: a second search a bounce.
    assert len(calls) == settings.spp * settings.bounces * (2 if route == "streamed_modes" else 1)
    assert got == want > 0


def _run(frames_at, traced, work=None, spans=None, device_ops=40):
    """A drive.Run of items at ``frames_at`` [(start, end)], ``traced`` the
    traced items' indices, with a hand-built trace of one traced item."""
    starts, ends = zip(*frames_at)
    run = drive.Run(loop="frames", setup_s=1.0, starts=list(starts), ends=list(ends), rays_per_item=1,
                    pixels=256, spp=2, triangles=100)
    run.trace = devtrace.Trace(wall_s=0.1, items=len(traced), busy_s=0.01, device_ops=device_ops, device_s=0.02,
                               by_name={}, span_device_s=spans or {}, idle_by_host=[])
    run.traced, run.work = traced, work
    return run


def _reader(name):
    return spec.reader(REPO, name)


def test_readers_read_spans_records_and_counter(small):
    """Each new reader on a hand-built trace and the frame records of real
    CPU renders: items 0, 1 and 3 untraced, item 2 under the profiler."""
    scene, camera, settings = small
    items = []
    for i in range(4):
        a = time.perf_counter()
        if i == 2:
            _traced_frame(small, seed=100 + i)
        else:
            render_frame(scene, camera, settings, seed=100 + i, device="cpu")
        items.append((a, time.perf_counter()))
    records = profiling.frame_records()[-4:]
    assert [r["seed"] for r in records] == [100, 101, 102, 103]
    spans = {"render.schedule": 0.004, "render.compact": 0.003, "render.shade": 0.006, "render.rng": 0.002}
    work = [BounceStats(lanes=256, live=256, counted=64, tests=160),
            BounceStats(lanes=256, live=128, counted=32, tests=96), BounceStats(lanes=256, live=0)]
    run = _run(items, range(2, 3), work=work, spans=spans)
    for name, span in (("schedule", "render.schedule"), ("compact", "render.compact"), ("shade", "render.shade"),
                       ("rng", "render.rng")):
        assert _reader(f"{name}_device_ms.render")(run) == pytest.approx(1e3 * spans[span])
    dispatch = sorted(1e3 * (r["end_s"] - r["start_s"]) for r in records if r["seed"] != 102)
    for part in ("render", "grad"):
        assert _reader(f"host_dispatch_ms.{part}")(run) == pytest.approx(dispatch[1])
    # Crossings a frame: spp x (256 rays x 160 / 64 + 128 rays x 96 / 32).
    crossings = 2 * (256 * 160 / 64 + 128 * 96 / 32)
    assert records[2]["tests"] > 0
    assert _reader("search_useful_pct.render")(run) == pytest.approx(100.0 * crossings / records[2]["tests"])
    # No device operation in the trace, or no trace: nothing to read.
    empty = _run(items, range(2, 3), work=work, spans=spans, device_ops=0)
    untraced = _run(items, range(0), work=work)
    untraced.trace = None
    for name in ("schedule_device_ms.render", "compact_device_ms.render", "shade_device_ms.render",
                 "rng_device_ms.render", "host_dispatch_ms.render", "host_dispatch_ms.grad",
                 "search_useful_pct.render"):
        assert _reader(name)(empty) is None and _reader(name)(untraced) is None


def test_readers_find_nothing_in_a_program_without_records(small, monkeypatch):
    """A program older than its spans and records (the readers run on both
    sides of a comparison): every new reader returns None, none raises."""
    items = [(1.0, 2.0), (2.0, 3.0)]
    run = _run(items, range(1, 2), work=[BounceStats(lanes=4, live=4, counted=4, tests=4)])
    monkeypatch.delattr(profiling, "frame_records")
    for name in ("schedule_device_ms.render", "compact_device_ms.render", "shade_device_ms.render",
                 "rng_device_ms.render", "host_dispatch_ms.render", "search_useful_pct.render"):
        assert _reader(name)(run) is None
