"""Top-level renderer: camera + scene + settings → image.

Counterpart of ``gpupathtracer_tpu/render/renderer.py``. ``render_frame``
packs the scene (once per block width; the pack is cached across frames),
then for each sample makes the PCG keys and the sub-pixel jitter, generates
primary rays and traces paths; the frame is the mean over samples. The
frame is differentiable (see ``render_frame``). The normal AOVs take one
closest-hit search of the unjittered camera rays. ``render_samples`` sums
the radiance over a range of global sample ids, the unit of progressive
and checkpointed rendering. ``intersector="bvh"`` builds the flattened BVH
on the host (``accel/bvh.py``, cached like the packs) and renders with its
traversal; ``render`` returns the frame as a host numpy array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpupathtracer_tpu_torch.accel.bvh import build_bvh, intersect_bvh
from gpupathtracer_tpu_torch.core.tensors import TensorCache, resolve_device
from gpupathtracer_tpu_torch.models.camera import Camera, generate_rays, generate_rays_for_pixels
from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops import packed_intersect
from gpupathtracer_tpu_torch.ops.plucker import K, NSCALARS
from gpupathtracer_tpu_torch.ops.sampling import make_sampler, prng_key_data
from gpupathtracer_tpu_torch.render.integrator import (
    IntegratorOptions,
    check_supported,
    make_intersect_fn,
    normal_aov,
    trace_paths,
)
from gpupathtracer_tpu_torch.utils import profiling
from gpupathtracer_tpu_torch.utils.debug import check_frame


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Render block of the config schema, with the JAX package's fields."""

    width: int = 800
    height: int = 800
    spp: int = 1
    bounces: int = 1
    seed: int = 1234
    jitter: bool = True  # sub-pixel jitter for spp > 1
    background: tuple = (0.0, 0.0, 0.0)
    aov: str = "radiance"  # "radiance", "normal" or "normal_unit"
    rr_start: int | None = None
    tri_block: int = 128
    ray_chunk: int = 8192  # rays per chunk of the brute intersector
    # Second pack width for bounces 1..N-1; None = one pack at tri_block.
    tri_block_secondary: int | None = None
    use_shading_normals: bool = False
    intersector: str = "auto"  # see render/integrator.py
    estimator: str = "naive"
    # "auto" resolves by the pack's size (narrow_settings): a pack on the
    # streamed route sorts with the "origin" key, a resident one does not
    # sort and keeps "dir".
    sort_rays: bool | str = "auto"
    sort_key: str = "auto"
    compact: bool = True
    compact_mode: str = "permute"
    kernel_precision: str = "auto"  # the searches' decision product (see IntegratorOptions)
    rng: str = "pcg"
    material_set: tuple = (0, 1, 2, 3)
    textured: bool = False


def _integrator_options(s: RenderSettings) -> IntegratorOptions:
    return IntegratorOptions(
        bounces=s.bounces,
        background=s.background,
        rr_start=s.rr_start,
        tri_block=s.tri_block,
        ray_chunk=s.ray_chunk,
        use_shading_normals=s.use_shading_normals,
        intersector=s.intersector,
        estimator=s.estimator,
        sort_rays=s.sort_rays if isinstance(s.sort_rays, bool) else False,
        sort_key=s.sort_key if s.sort_key != "auto" else "dir",
        compact=s.compact,
        compact_mode=s.compact_mode,
        kernel_precision=s.kernel_precision,
        material_set=s.material_set,
        rng=s.rng,
        textured=s.textured,
    )


_FULL_MATERIAL_SET = (0, 1, 2, 3)


def scene_material_set(scene: TriangleScene) -> tuple:
    """The sorted material types (``BxdfType`` values) that the scene's live
    triangles use; all triangles' where none is live."""
    mat_id = scene.mat_id[scene.valid] if bool(scene.valid.any()) else scene.mat_id
    return tuple(sorted(int(t) for t in torch.unique(scene.materials.type[torch.unique(mat_id)])))


def narrow_settings(scene: TriangleScene, settings: RenderSettings) -> RenderSettings:
    """Narrow a still-default ``material_set`` to the types the scene's live
    triangles use, turn ``textured`` on when a live material uses a texture
    (never off), and resolve the sort autos as the JAX package does: the
    primary pack's size (live rows plus two-sided duplicates, rounded up to
    whole blocks of ``tri_block``) against ``RESIDENT_BUDGET_BYTES`` decides
    ``sort_rays`` (on when streamed) and ``sort_key`` ("origin" when
    streamed, else "dir"). An explicit value wins."""
    if settings.sort_rays == "auto" or settings.sort_key == "auto":
        rows = int(scene.valid.sum()) + int((scene.two_sided & scene.valid).sum())
        tb = settings.tri_block
        rows_padded = -(-rows // tb) * tb
        streamed = rows_padded * K * NSCALARS * 4 > packed_intersect.RESIDENT_BUDGET_BYTES
        if settings.sort_rays == "auto":
            settings = dataclasses.replace(settings, sort_rays=streamed)
        if settings.sort_key == "auto":
            settings = dataclasses.replace(settings, sort_key="origin" if streamed else "dir")
    if not settings.textured:
        used = torch.unique(scene.mat_id[scene.valid])
        if bool((scene.materials.tex_kind[used] > 0).any()):
            settings = dataclasses.replace(settings, textured=True)
    if tuple(settings.material_set) == _FULL_MATERIAL_SET:
        settings = dataclasses.replace(settings, material_set=scene_material_set(scene))
    return settings


_AOVS = ("radiance", "normal", "normal_unit")


def _prepare(scene, camera, settings, device):
    """The scene and camera on ``device``, the narrowed settings and the
    packs (cached, see ``render_frame``)."""
    if settings.aov not in _AOVS:
        raise ValueError(f"unknown aov {settings.aov!r}")
    if (camera.width, camera.height) != (settings.width, settings.height):
        raise ValueError("camera/screen size mismatch")
    scene = scene.to(device)
    camera = camera.to(device)
    settings = narrow_settings(scene, settings)
    check_supported(_integrator_options(settings))
    if settings.intersector in ("brute", "bvh"):  # search the scene or its BVH, no pack
        return scene, camera, settings, None, None
    packed = packed_intersect.pack_scene(scene, tri_block=settings.tri_block)  # detached
    packed2 = None
    if settings.tri_block_secondary is not None and settings.bounces > 1:
        packed2 = packed_intersect.pack_scene(scene, tri_block=settings.tri_block_secondary)
    return scene, camera, settings, packed, packed2


def render_frame(
    scene: TriangleScene,
    camera: Camera,
    settings: RenderSettings,
    seed: int | None = None,
    device="cuda",
) -> torch.Tensor:
    """Render a frame on ``device`` (the card unless the caller passes
    ``device="cpu"``); returns the mean radiance (H, W, 3) float32, or for
    ``aov="normal"``/``"normal_unit"`` the absolute normal of the closest
    hit of each pixel's unjittered camera ray (``normal_aov``).
    ``seed=None`` uses ``settings.seed``.

    The frame is differentiable with the JAX package's estimator (interior
    term, detached sampling): a gradient reaches every tensor of the scene,
    its materials and the camera that requires one, through the camera rays,
    ``resolve_hits``, shading, emission, the NEE geometry term and MIS
    weights, the light table's total area and the film's mean, with one
    graph across the samples. The searches, the packs, the sort keys and
    the shadow rays are detached, so a ``Hit`` never carries a gradient.
    With no input that requires a gradient nothing is recorded.

    The packs are cached on the identity and version of the scene's
    tensors, so a scene that already lives on ``device`` is packed once
    across frames and again after an in-place edit; a scene moved here is
    packed again on every call.

    ``intersector="bvh"`` searches the scene's BVH (``_cached_bvh``, built on
    the host and cached as the packs are) with ``intersect_bvh`` for every
    closest hit and every shadow ray (thresholded), as the JAX package's
    ``render_frame`` does; no kernel runs.

    Each call is recorded (``utils.profiling.frame``): its host start and
    return, and while a profiler records, the ``render.frame`` span with
    its seed and the searches' test counter."""
    device = resolve_device(device)
    seed = settings.seed if seed is None else seed
    with profiling.frame(seed, device):
        return _render_frame(scene, camera, settings, seed, device)


def _render_frame(scene, camera, settings, seed, device) -> torch.Tensor:
    scene, camera, settings, packed, packed2 = _prepare(scene, camera, settings, device)
    h, w = settings.height, settings.width
    intersect_fn = None
    if settings.intersector == "bvh":
        bvh = _cached_bvh(scene)
        intersect_fn = lambda o, d, alive=None: intersect_bvh(o, d, scene, bvh)
    if settings.aov != "radiance":
        o, d = generate_rays(camera)
        opts = _integrator_options(settings)
        color = normal_aov(scene, o, d, opts, reference_parity=settings.aov == "normal",
                           intersect_fn=intersect_fn or make_intersect_fn(scene, opts, packed=packed))
        return check_frame(color.reshape(h, w, 3), "render_frame")
    pixel_idx = torch.arange(h * w, device=device)
    key_data = prng_key_data(seed)
    film_sum = accumulate_radiance(
        scene, camera, pixel_idx, settings, key_data, packed=packed, packed_secondary=packed2,
        intersect_fn=intersect_fn,
    )
    return check_frame((film_sum / settings.spp).reshape(h, w, 3), "render_frame")


def render_samples(
    scene: TriangleScene,
    camera: Camera,
    settings: RenderSettings,
    sample_start: int,
    num_samples: int,
    seed: int | None = None,
    device="cuda",
) -> torch.Tensor:
    """The radiance SUM (H, W, 3) over global samples
    ``[sample_start, sample_start + num_samples)``, on ``device`` as
    ``render_frame``. Sample keys depend only on (seed, pixel, sample id), so
    summing the chunks of a partition of ``[0, spp)`` in order gives
    ``render_frame · spp``: the sums are formed in the same order. Always
    the radiance, whatever ``settings.aov`` says (as the JAX package's)."""
    device = resolve_device(device)
    scene, camera, settings, packed, packed2 = _prepare(scene, camera, settings, device)
    h, w = settings.height, settings.width
    pixel_idx = torch.arange(h * w, device=device)
    key_data = prng_key_data(settings.seed if seed is None else seed)
    film_sum = accumulate_radiance(
        scene, camera, pixel_idx, settings, key_data, packed=packed, packed_secondary=packed2,
        sample_start=sample_start, num_samples=num_samples,
    )
    return check_frame(film_sum.reshape(h, w, 3), "render_samples")


def accumulate_radiance(
    scene, camera, pixel_idx, settings, key_data, packed, packed_secondary=None, sample_start=0, num_samples=None,
    intersect_fn=None,
):
    """Sum of the radiance of the given pixels over global samples
    ``[sample_start, sample_start + num_samples)`` (all ``settings.spp`` by
    default). Sample keys depend only on (seed, pixel id, sample id), so any
    split of the pixels or of the samples gives the same per-sample values.
    ``intersect_fn`` replaces the packed search (``trace_paths``)."""
    opts = _integrator_options(settings)
    n = settings.spp if num_samples is None else num_samples
    film_sum = torch.zeros((pixel_idx.shape[0], 3), dtype=torch.float32, device=pixel_idx.device)
    for s in range(sample_start, sample_start + n):
        o, d, keys = sample_rays(camera, pixel_idx, settings, key_data, s)
        film_sum = film_sum + trace_paths(
            scene, o, d, keys, opts, intersect_fn=intersect_fn, packed=packed, packed_secondary=packed_secondary
        )
    return film_sum


def sample_rays(camera, pixel_idx, settings, key_data, s: int):
    """``(origins, directions, keys)`` of global sample ``s`` of the given
    pixels: the path keys of (seed, pixel id, sample id), and the camera
    rays through the sub-pixel jitter those keys draw (spp > 1 with
    ``settings.jitter``) or through the pixel centres."""
    sampler = make_sampler(settings.rng)
    keys = sampler.path_keys(key_data, pixel_idx, s)
    jitter_uv = None
    if settings.jitter and settings.spp > 1:
        jitter_uv = sampler.uniform(sampler.fold(keys, 0xA11A), 2)
    o, d = generate_rays_for_pixels(camera, pixel_idx, jitter_uv)
    return o, d, keys


# BVH cache, as the pack cache: keyed on the four tensors the builder reads.
_BVH_CACHE = TensorCache(size=4)


def _cached_bvh(scene: TriangleScene):
    """The scene's BVH (``accel.bvh.build_bvh`` at its default leaf size),
    built once per geometry and again after an in-place edit."""
    return _BVH_CACHE.get((scene.v0, scene.e1, scene.e2, scene.valid), (), lambda: build_bvh(scene))


def render(scene: TriangleScene, camera: Camera, settings: RenderSettings, device="cuda") -> np.ndarray:
    """``render_frame`` on ``device``, returned as a host numpy array."""
    return render_frame(scene, camera, settings, device=device).detach().cpu().numpy()
