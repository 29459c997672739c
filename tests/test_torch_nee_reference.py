"""The port's NEE frame against the benchmark's plain NEE reference
(``h100_bench/reference/nee.py``), both on the CPU, on config 6's floor
and tilted light with a subdivision-2 icosphere, resident and with the
streamed route forced; and what the reference refuses.

Imports no JAX."""

import dataclasses
import json
import os

import pytest
import torch

from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils.config import load_scene_file
from h100_bench.reference import nee
from h100_bench.reference import scene as ref_scene
from h100_bench.reference import trace as ref_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
SEED = 2 ** 31 + 19
# Where both find the same triangles the two images agree to a few float32
# ulps (the reference builds its own world-space vertices, which round
# differently by an ulp); a path that takes another triangle, or a shadow
# ray answered otherwise, moves its pixel by far more. 1e-4 is the check's
# own pixel tolerance (check.PIXEL_TOL).
PIXEL_TOL = 1e-4


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    with open(os.path.join(REPO, "h100_bench", "configs", "config6_nee.json")) as f:
        cfg = json.load(f)
    cfg["render"]["width"] = cfg["render"]["height"] = SIZE
    cfg["geometry"][0]["subdivisions"] = 2
    path = tmp_path_factory.mktemp("nee") / "c6nee.json"
    path.write_text(json.dumps(cfg))
    ref = ref_scene.build_scene(cfg, "cpu")
    return cfg, str(path), ref, ref_trace.build_boxes(ref)


@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_the_port_nee_frame_equals_the_reference(small, route, monkeypatch):
    cfg, path, ref, boxes = small
    if route == "streamed":  # as h100_bench/conftest.run_cpu forces it
        monkeypatch.setattr(tpi, "RESIDENT_BUDGET_BYTES", 64 * 1024)
        monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", 16 * 1024)
    anyhit = []
    search = tpi.occluded_streamed_reference

    def spy(*args, **kwargs):
        anyhit.append(args)
        return search(*args, **kwargs)

    monkeypatch.setattr(tpi, "occluded_streamed_reference", spy)
    scene, camera, settings = load_scene_file(path, device="cpu")
    settings = dataclasses.replace(settings, spp=1)
    assert settings.estimator == "nee" and settings.bounces == 4
    image = render_frame(scene, camera, settings, seed=SEED, device="cpu").reshape(-1, 3)
    # Bounces 1-3 answer their shadow rays with K4's plain version on the
    # streamed route; bounce 0 thresholds a closest hit.
    assert len(anyhit) == (settings.bounces - 1 if route == "streamed" else 0)
    stats = [ref_trace.BounceStats() for _ in range(settings.bounces)]
    want = nee.trace_pixels(ref, boxes, ref_scene.build_camera(cfg), torch.arange(SIZE * SIZE), SEED, 1,
                            settings.bounces, count_rays=64, stats=stats)
    assert (image - want).abs().max().item() <= PIXEL_TOL
    # The light sample is most of the image: the naive estimator's differs.
    naive = ref_trace.trace_pixels(ref, boxes, ref_scene.build_camera(cfg), torch.arange(SIZE * SIZE), SEED, 1,
                                   settings.bounces)
    assert (naive - want).abs().amax(-1).gt(0.01).float().mean() > 0.2
    # The reference counted the shadow rays' any-hit work of every bounce.
    for st in stats:
        assert 0 < st.shadow_live <= st.live and 0 < st.shadow_counted <= 64
        assert st.shadow_counted <= st.shadow_tests


def test_the_reference_refuses_mis_mirror_and_textures(small):
    cfg, _, _, _ = small
    with pytest.raises(ValueError, match="'mis'.*reference/mis.py"):
        ref_trace.load_estimator("mis")
    pixels = torch.arange(16)
    for change, what in (({"texture": {"kind": "checker"}}, "texture"), ({"type": "mirror"}, "'mirror'"),
                         ({"type": "glass"}, "'glass'")):
        bad = json.loads(json.dumps(cfg))
        bad["materials"][0].update(change)
        s = ref_scene.build_scene(bad, "cpu")
        with pytest.raises(ValueError, match=f"nee reference has no .*{what}"):
            nee.trace_pixels(s, ref_trace.build_boxes(s), ref_scene.build_camera(bad), pixels, 1, 1, 2)


def test_the_float32_camera_is_the_viewers(small):
    """The reference's float32 camera gives the program's rays to the bit,
    and the float64 one of trace.py differs from them by rounding only."""
    from gpupathtracer_tpu_torch.models.camera import generate_rays_for_pixels

    cfg, path, _, _ = small
    _, camera, _ = load_scene_file(path, device="cpu")
    pixels = torch.arange(SIZE * SIZE)
    jitter = torch.rand(pixels.shape[0], 2, generator=torch.Generator().manual_seed(2))
    cam = ref_scene.build_camera(cfg)
    for ju in (None, jitter):
        o, d = nee.camera_rays(cam, pixels, ju)
        po, pd = generate_rays_for_pixels(camera, pixels, ju)
        assert torch.equal(o, po) and torch.equal(d, pd)
        _, d64 = ref_trace.camera_rays(cam, ref_scene.camera_matrix(cam), pixels, ju)
        assert 0 < (d - d64).abs().max().item() < 1e-5
