"""The benchmark's arithmetic on hand-made inputs: the window, the interval
union, the box-crossing work count, the roofline bound and the reference's
search."""

import math

import pytest
import torch

from h100_bench import devtrace, drive, roofline
from h100_bench.reference import scene as ref_scene
from h100_bench.reference import trace as ref_trace


def _run(starts, ends, rays=10):
    return drive.Run(loop="frames", setup_s=1.0, starts=starts, ends=ends, rays_per_item=rays, pixels=4, spp=1,
                     triangles=1)


def test_rate_is_all_the_work_over_all_the_window():
    # Three frames of 10 rays; the window runs from the first start to the
    # last end, gaps between frames included.
    run = _run([0.0, 1.5, 2.0], [1.0, 2.0, 4.0])
    assert run.window_s == 4.0
    assert run.rate() == pytest.approx(30 / 4.0)


def test_the_tail_is_over_every_frame():
    ends = [float(i) + (0.001 if i < 95 else 1.0) for i in range(100)]
    run = _run([float(i) for i in range(100)], ends)
    assert run.latency_ms(95) > 1.0  # the five slow frames are in the tail
    assert run.latency_ms(50) == pytest.approx(1.0)


def test_interval_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert devtrace.union_length(iv) == pytest.approx(5.0)
    assert devtrace.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert devtrace.union_length([]) == 0.0


def test_innermost_op_labels_a_gap():
    ops = [(0, 10, "frame"), (2, 4, "aten::add"), (2.5, 3.0, "cudaLaunchKernel")]
    assert devtrace.innermost_at([1, 2.7, 3.5, 11], ops) == ["frame", "cudaLaunchKernel", "aten::add", None]


def _scene(tris, two_sided=False):
    t = torch.tensor(tris, dtype=torch.float32)
    n = t.shape[0]
    return ref_scene.RefScene(v0=t[:, 0], e1=t[:, 1] - t[:, 0], e2=t[:, 2] - t[:, 0],
                              two_sided=torch.full((n,), two_sided), mat=torch.zeros(n, dtype=torch.int64),
                              albedo=torch.ones(1, 3), emission=torch.zeros(1, 3),
                              is_emitter=torch.zeros(1, dtype=torch.bool))


def test_box_crossings_by_hand():
    # Three unit triangles facing +z at z = 0, -2 and -4, and one off to the
    # side. A ray down -z through (0.2, 0.2) enters the boxes at z = 0, -2,
    # -4 but its closest hit is at z = 0 (t = 1): one box before the hit. A
    # ray that misses everything enters the three stacked boxes.
    tri = lambda z, x=0.0: [[x, 0, z], [x + 1, 0, z], [x, 1, z]]
    scene = _scene([tri(0), tri(-2), tri(-4), tri(0, 5.0)], two_sided=True)
    boxes = ref_trace.build_boxes(scene)
    o = torch.tensor([[0.2, 0.2, 1.0], [0.9, 0.9, 1.0], [5.2, 0.2, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    tri_i, t = ref_trace.closest_hit(boxes, o, d)
    assert tri_i.tolist() == [0, -1, 3]
    assert t[0].item() == pytest.approx(1.0) and math.isinf(t[1].item())
    count = ref_trace.boxes_entered(boxes, o, d, t)
    # The miss at (0.9, 0.9) is inside the boxes (0.9 < 1) but outside the
    # triangles (0.9 + 0.9 > 1).
    assert count.tolist() == [1, 3, 1]
    assert (count <= scene.num_triangles).all()


def test_search_and_count_against_dense(rng_scene):
    scene, o, d = rng_scene
    boxes = ref_trace.build_boxes(scene)
    tri_i, t = ref_trace.closest_hit(boxes, o, d)
    # Dense float64 Moller-Trumbore over every triangle.
    v0, e1, e2 = scene.v0.double(), scene.e1.double(), scene.e2.double()
    od, dd = o.double()[:, None], d.double()[:, None]
    p = torch.linalg.cross(dd.expand(-1, v0.shape[0], -1), e2[None].expand(o.shape[0], -1, -1))
    det = (e1[None] * p).sum(-1)
    s = od - v0[None]
    u = (s * p).sum(-1) / det
    q = torch.linalg.cross(s, e1[None].expand_as(s))
    v = (dd * q).sum(-1) / det
    tt = (e2[None] * q).sum(-1) / det
    ok = (det >= 1e-6) & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 1e-6)
    dense_t = torch.where(ok, tt, math.inf).amin(-1)
    assert torch.equal(torch.isinf(dense_t), tri_i < 0)
    assert torch.allclose(t[tri_i >= 0], dense_t[tri_i >= 0], rtol=1e-12, atol=0)
    count = ref_trace.boxes_entered(boxes, o, d, t)
    lo = torch.stack([v0, v0 + e1, v0 + e2], 1).amin(1)
    hi = torch.stack([v0, v0 + e1, v0 + e2], 1).amax(1)
    inv = 1.0 / d.double()
    t1, t2 = (lo[None] - o.double()[:, None]) * inv[:, None], (hi[None] - o.double()[:, None]) * inv[:, None]
    near, far = torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)
    dense = ((near <= far) & (far >= 0) & (near <= t.double()[:, None])).sum(-1)
    assert torch.equal(count, dense)
    assert (count <= scene.num_triangles).all()


@pytest.fixture
def rng_scene():
    g = torch.Generator().manual_seed(3)
    v0 = torch.rand(300, 3, generator=g) * 4 - 2
    tris = torch.stack([v0, v0 + torch.rand(300, 3, generator=g) * 0.5, v0 + torch.rand(300, 3, generator=g) * 0.5], 1)
    o = torch.rand(500, 3, generator=g) * 8 - 4
    d = torch.nn.functional.normalize(torch.randn(500, 3, generator=g), dim=-1)
    return _scene(tris.tolist()), o, d


def test_roofline_bound():
    # 1e6 rays, 10 tests each: 4.6e8 FLOP at 67 TFLOP/s is 6.87 us; the
    # bytes, 1e6 x 32 + 1000 x 36, take 9.56 us at 3.35 TB/s: memory bound.
    b = roofline.bound_s(1e6, 1e7, 1000)
    assert b == pytest.approx((1e6 * 32 + 1000 * 36) / 3.35e12)
    assert roofline.bound_s(1e6, 1e9, 1000) == pytest.approx(46e9 / 67e12)
    st = [ref_trace.BounceStats(lanes=10, live=10, counted=5, tests=50), ref_trace.BounceStats(lanes=10, live=0)]
    assert roofline.closest_hit_frame_bound_s(st, 100, 2, 1000) == pytest.approx(2 * roofline.bound_s(100, 1000, 1000))
    assert roofline.closest_hit_frame_bound_s([ref_trace.BounceStats(lanes=10, live=5)], 100, 1, 10) is None
    occ = torch.tensor([True, False, False])
    assert roofline.anyhit_tests(occ, torch.tensor([9, 4, 2])) == 1 + 4 + 2


def test_pcg_words_wrap_at_32_bits():
    a = torch.tensor([0xFFFFFFFF, 0x12345678, 7])
    assert ref_trace.mul32(a, 0x9E3779B9).tolist() == [(x * 0x9E3779B9) & 0xFFFFFFFF for x in a.tolist()]


def test_icosphere_counts():
    from h100_bench.reference.geometry.sphere import icosphere

    assert icosphere(0).shape == (20, 3, 3)
    t = icosphere(3)
    assert t.shape == (1280, 3, 3)
    assert torch.allclose(torch.linalg.norm(torch.as_tensor(t), dim=-1), torch.ones(1280, 3), atol=1e-6)


class _Event:
    def __init__(self, name, dev, start, dur, corr=0, linked=0, annotation=False):
        self._v = (name, dev, start, dur, corr, linked, annotation)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def is_user_annotation(self): return self._v[6]


def test_trace_parse_on_hand_made_events(monkeypatch):
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event("h100_bench.frame", cpu, 0, 1000, annotation=True),
        _Event("h100_bench.backward", cpu, 500, 400, annotation=True),
        _Event("aten::add", cpu, 100, 50, corr=1),
        _Event("aten::index_add_", cpu, 600, 50, corr=2),
        _Event("void closest_hit_kernel<2>(int)", cuda, 200, 300, linked=1),
        _Event("indexFuncLargeIndex", cuda, 650, 100, linked=2),
        _Event("h100_bench.backward", cuda, 600, 200, annotation=True),  # the span's device row: not an op
    ]
    monkeypatch.setattr(devtrace, "_events", lambda prof: events)
    t = devtrace.parse(None, wall_s=1e-6, items=1)
    assert t.device_ops == 2 and t.busy_s == pytest.approx(400e-9)
    assert t.kernel_s(devtrace.SEARCH_KERNELS["k1"]) == pytest.approx(300e-9)
    assert t.search_s() == pytest.approx(300e-9)
    assert t.span_device_s["h100_bench.backward"] == pytest.approx(100e-9)
    assert t.span_device_s["h100_bench.frame"] == pytest.approx(400e-9)
    # Idle gaps [0, 200), [500, 650), [750, 1000), each named by the
    # innermost op at its midpoint: aten::add at 100, the backward span at
    # 575 and 875.
    labels = dict((k.split(" (")[0], v) for k, v in t.idle_by_host)
    assert labels == {"aten::add": pytest.approx(200e-9), "h100_bench.backward": pytest.approx(400e-9)}


def test_a_metric_without_a_file_of_its_own_is_read_by_its_base():
    from h100_bench import spec
    from h100_bench.conftest import REPO

    base = spec.reader(REPO, "rays_per_s")
    assert spec.reader(REPO, "rays_per_s.streamed").__code__.co_code == base.__code__.co_code
    with pytest.raises(FileNotFoundError):
        spec.reader(REPO, "no_such_metric.render")


def test_device_idle_is_taken_against_the_untraced_items():
    import importlib.util
    import os

    from h100_bench.conftest import REPO

    path = os.path.join(REPO, "h100_bench", "metrics", "device_idle_pct.py")
    mod_spec = importlib.util.spec_from_file_location("idle", path)
    idle = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(idle)
    # Items of 0.1 s, but the two traced ones stretched to 0.5 s by the
    # profiler; the device was busy 0.04 s an item: 60% idle.
    lat = [0.1, 0.1, 0.5, 0.5, 0.1, 0.1, 0.1]
    starts = [float(i) for i in range(len(lat))]
    run = _run(starts, [a + b for a, b in zip(starts, lat)])
    assert idle.read(run) is None
    run.traced = range(2, 4)
    run.trace = devtrace.Trace(wall_s=1.0, items=2, busy_s=0.08, device_ops=10, device_s=0.08, by_name={},
                               span_device_s={}, idle_by_host=[])
    assert run.latency_ms(50, untraced=True) == pytest.approx(100.0)
    assert idle.read(run) == pytest.approx(60.0)


def test_the_estimator_and_geometry_are_found_by_the_configuration_names(tmp_path):
    """A new estimator is a new file, ``reference/<name>.py``, and a new
    geometry kind ``reference/geometry/<kind>.py``; the naive estimator
    refuses a texture."""
    import os
    import shutil
    import subprocess
    import sys

    from h100_bench.conftest import REPO

    shutil.copytree(os.path.join(REPO, "h100_bench"), tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "h100_bench" / "reference" / "twin.py").write_text(
        '"""The naive estimator under another name."""\n\nfrom h100_bench.reference.naive import radiance  # noqa\n')
    (tmp_path / "h100_bench" / "reference" / "geometry" / "ball.py").write_text(
        '"""A sphere under another name."""\n\nfrom h100_bench.reference.geometry.sphere import triangles  # noqa\n')
    code = ("import sys; sys.path.insert(0, {root!r}); import torch; "
            "from h100_bench.reference import scene, trace; "
            "cfg = scene.load_config({cfg!r}); cfg['render'].update(width=16, height=16); "
            "cfg['geometry'][0]['subdivisions'] = 1; s = scene.build_scene(cfg, 'cpu'); b = trace.build_boxes(s); "
            "cam = scene.build_camera(cfg); px = torch.arange(256); "
            "a, t = (trace.trace_pixels(s, b, cam, px, 7, 2, 4, estimator=e) for e in ('naive', 'twin')); "
            "assert torch.equal(a, t) and a.abs().sum() > 0; "
            "assert trace.load_estimator('twin').__file__.startswith({root!r})\n"
            "cfg['geometry'][0]['kind'] = 'ball'; s2 = scene.build_scene(cfg, 'cpu')\n"
            "assert torch.equal(s2.v0, s.v0) and s2.source.max() == len(cfg['geometry']) - 1\n"
            "cfg['materials'][0]['texture'] = {{'kind': 'checker'}}; s3 = scene.build_scene(cfg, 'cpu')\n"
            "try:\n    trace.trace_pixels(s3, b, cam, px, 7, 2, 4)\nexcept ValueError as e:\n    print('naive refused', e)\n"
            "try:\n    scene.geometry('torus')\nexcept ValueError as e:\n    print('no torus', e)\n"
            "try:\n    trace.load_estimator('nee')\nexcept ValueError as e:\n    print('refused', e)").format(
        root=str(tmp_path), cfg=os.path.join(REPO, "h100_bench", "configs", "config3_icosphere.json"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "refused" in p.stdout and "reference/nee.py" in p.stdout
    assert "naive refused" in p.stdout and "reference/geometry/torus.py" in p.stdout
