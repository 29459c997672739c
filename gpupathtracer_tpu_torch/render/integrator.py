"""Wavefront Monte Carlo path-tracing integrator: naive, NEE and MIS.

Counterpart of ``gpupathtracer_tpu/render/integrator.py``: per bounce,
intersect, add the background on misses and the emitter term on emitter
hits, and scatter the other hits: diffuse over the cosine-weighted
hemisphere (throughput factor = the albedo, flat or from the material's
checker or image texture), mirror by perfect reflection (× the specular
color), glass by Schlick-Fresnel-weighted reflection or refraction (×
the transmittance when refracted). With ``estimator="nee"`` every diffuse
vertex also samples a point on an emitter (area-weighted) and casts a
shadow ray; ``"mis"`` weights that light sample and the emitter hits of
BSDF samples with the balance heuristic. ``rr_start`` turns on Russian
roulette from that bounce. Liveness is data: dead lanes keep executing
with no effect.

Bounce 0 runs uncompacted. The later bounces drop dead lanes by
``compact_mode``: "permute" moves live rays to the front
(``ops/compaction.py``), sorted for tile coherence with ``sort_rays``, and
compacts shadow rays (never sorted) on every bounce; "mask" hands the live
mask to the search as ``alive`` and shadow rays go uncompacted with
``max_t = 0`` on dead lanes (no permutation; with ``sort_rays`` it
permutes, since the sort needs the permutation); "hybrid" permutes the whole
path state once after bounce 0 and runs the later bounces in mask mode.
Per-lane results do not depend on the lane's position, so the three modes
give the same image.

The step is differentiable as the JAX package's: the searches and the
shadow rays with their cutoffs are detached, everything else (hit
attributes, materials, emission, the NEE geometry term, MIS weights, the
light table's total area, the Fresnel and roulette weights) carries
gradients.

The ``brute`` intersector runs the Möller–Trumbore oracle
(``ops/intersect.py``) over the unpacked scene, in triangle blocks of
``tri_block`` and ray chunks of ``ray_chunk``; its shadow rays threshold its
closest hit. The ``bvh`` intersector is ``render_frame``'s alone: it
builds the BVH and hands ``accel/bvh.intersect_bvh`` in as a custom
intersect function; ``make_intersect_fn`` raises ValueError for it, as the
JAX package's does. ``rng`` picks the PCG or the threefry sampler
(``ops/sampling.py``).

The shade step has two routes, which ``shade_route`` picks from what a call
can observe: "fused" runs it as one launch of a CUDA kernel
(``ops/shade.py``) where the tensors are on the card, nothing that enters
it requires a gradient, the estimator is naive, the sampler PCG and the
materials diffuse or emitter, untextured; "ops" runs the torch ops below,
which carry gradients and serve every other call, and of which the kernel
computes the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch

from gpupathtracer_tpu_torch.core.tensors import absolute, clip, maximum
from gpupathtracer_tpu_torch.models.materials import BxdfType, textured_albedo
from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops import packed_intersect
from gpupathtracer_tpu_torch.ops.compaction import compact_rays, compact_rays_coherent, partition_alive
from gpupathtracer_tpu_torch.ops.intersect import Hit, intersect_brute, resolve_hits
from gpupathtracer_tpu_torch.ops.sampling import (
    SAMPLERS,
    cosine_sample_hemisphere,
    fresnel_schlick,
    local_to_world,
    make_sampler,
    normalize_dir,
    reflect,
    refract,
)
from gpupathtracer_tpu_torch.ops.shade import naive_shade
from gpupathtracer_tpu_torch.utils.profiling import scope

# Offset along the oriented normal when spawning secondary and shadow rays.
RAY_OFFSET = 1e-4

# Intersector names: "auto" and "pallas" run the kernels (their plain
# versions on CPU tensors); "plucker" runs the plain PyTorch versions on any
# device, as the JAX package's "plucker" runs its plain jnp product; "brute"
# runs the Möller–Trumbore oracle, which needs no pack; "bvh" needs no pack
# either and takes a caller's intersect function (render_frame's).
_KERNEL_INTERSECTORS = ("auto", "pallas")
_PLAIN_INTERSECTORS = ("plucker",)
_UNPACKED_INTERSECTORS = ("brute", "bvh")
_ESTIMATORS = ("naive", "nee", "mis")
_SORT_KEYS = ("dir", "origin")
_COMPACT_MODES = ("permute", "mask", "hybrid")
# The material types the fused shade step implements.
FUSED_MATERIALS = frozenset((BxdfType.EMITTER, BxdfType.DIFFUSE))
# The shade step's routes; a render.shade span records its route's index.
SHADE_ROUTES = ("ops", "fused")


@dataclasses.dataclass(frozen=True)
class IntegratorOptions:
    bounces: int = 4
    background: tuple = (0.0, 0.0, 0.0)
    rr_start: int | None = None  # Russian roulette from this bounce; None = off
    tri_block: int = 128
    ray_chunk: int = 8192  # rays per chunk of the brute intersector
    use_shading_normals: bool = False
    intersector: str = "auto"
    estimator: str = "naive"  # "naive", "nee" or "mis"
    # Sort rays for tile coherence: folded into the compaction permutation
    # of the scan bounces (compact_rays_coherent), or, with compaction off, a
    # sort around every closest-hit call (make_sorted_intersect).
    sort_rays: bool = False
    sort_key: str = "dir"  # "dir" or "origin": the sort key's layout
    compact: bool = True
    compact_mode: str = "permute"  # "permute", "mask" or "hybrid" (see the module docstring)
    # The decision product of the kernel route's searches
    # (ops/packed_intersect.py PRECISIONS): "auto" resolves to "highest"
    # (f32); "high", "mixed" and "default" are the JAX package's bf16 modes.
    # The plain intersector ("plucker") always computes in f32, as the JAX
    # package's dense plucker search does.
    kernel_precision: str = "auto"
    material_set: tuple = (0, 1, 2, 3)
    rng: str = "pcg"
    # Diffuse albedo from the hit UV (checker / image); narrow_settings turns
    # it on when a live material uses a texture.
    textured: bool = False


def check_supported(options: IntegratorOptions) -> None:
    """Raise ValueError for unknown option values."""
    if options.intersector not in _KERNEL_INTERSECTORS + _PLAIN_INTERSECTORS + _UNPACKED_INTERSECTORS:
        raise ValueError(f"unknown intersector {options.intersector!r}")
    if options.rng not in SAMPLERS:
        raise ValueError(f"unknown rng {options.rng!r}")
    if options.estimator not in _ESTIMATORS:
        raise ValueError(f"unknown estimator {options.estimator!r}")
    if options.sort_key not in _SORT_KEYS:
        raise ValueError(f"unknown sort key {options.sort_key!r}")
    if options.compact_mode not in _COMPACT_MODES:
        raise ValueError(f"unknown compact_mode {options.compact_mode!r}")
    packed_intersect.resolve_precision(options.kernel_precision)


def resolved_intersector(options: IntegratorOptions) -> str:
    """The intersector that runs: "auto" is the kernel route ("pallas"),
    whose wrappers launch the CUDA kernels on the card's tensors and run
    their plain versions on the CPU's; any other name stands."""
    return "pallas" if options.intersector == "auto" else options.intersector


def _search_kwargs(options: IntegratorOptions) -> dict:
    """``plain`` and ``precision`` of the packed searches for ``options``:
    the kernel route takes ``kernel_precision``, the plain one f32."""
    plain = options.intersector in _PLAIN_INTERSECTORS
    return {"plain": plain, "precision": "highest" if plain else options.kernel_precision}


def make_intersect_fn(scene: TriangleScene, options: IntegratorOptions, packed=None):
    """Closest-hit function ``(o, d, alive=None) -> Hit`` over the packed
    scene (packed here at ``options.tri_block`` unless ``packed`` is
    given). With ``sort_rays`` and compaction off it sorts every call's rays
    (``make_sorted_intersect``); with compaction on the sort is part of the
    compaction permutation instead. The brute intersector searches the
    scene itself (no pack, no sort); its callers mask the lanes that are
    not alive. The bvh intersector has none of its own and raises
    ValueError, as the JAX package's ``make_intersect_fn`` does."""
    check_supported(options)
    which = resolved_intersector(options)
    if which == "bvh":
        raise ValueError("intersector 'bvh' has no intersect function of its own: render_frame builds the BVH "
                         "and passes intersect_bvh in, and no other path takes it (as in the JAX package)")
    if which in _UNPACKED_INTERSECTORS:
        return lambda o, d, alive=None: intersect_brute(
            o, d, scene, tri_block=options.tri_block, ray_chunk=options.ray_chunk
        )
    if packed is None:
        packed = packed_intersect.pack_scene(scene, tri_block=options.tri_block)
    fn = partial(packed_intersect.intersect_packed, packed=packed, **_search_kwargs(options))
    if options.sort_rays and not options.compact:
        return packed_intersect.make_sorted_intersect(fn, packed, key_mode=options.sort_key)
    return fn


def make_occlusion_fn(
    scene: TriangleScene, options: IntegratorOptions, intersect_fn, packed=None, use_kernel: bool = False
):
    """``occluded(o, d, max_t) -> bool (R,)``: some accepted hit with
    t < max_t; lanes with ``max_t = 0`` report False.

    ``use_kernel=True`` runs the any-hit search over ``packed`` (its plain
    version for the plain intersector); otherwise, and always for the
    brute intersector, the closest hit of ``intersect_fn`` is thresholded,
    with the ``max_t = 0`` lanes passed as dead. Both answer the same
    predicate.
    """
    if use_kernel and options.intersector not in _UNPACKED_INTERSECTORS:
        if packed is None:
            packed = packed_intersect.pack_scene(scene, tri_block=options.tri_block)
        return partial(packed_intersect.intersect_packed_occluded, packed=packed, **_search_kwargs(options))

    def threshold(o, d, mt):
        h = intersect_fn(o, d, alive=mt > 0)
        return h.hit & (h.t < mt)

    return threshold


def shade_route(options: IntegratorOptions, device: torch.device, inputs=()) -> str:
    """The route of a bounce's shade step: "fused", one launch of the naive
    shade kernel (``ops/shade.py``), where the call's tensors are on
    ``device`` = CUDA, none of ``inputs`` (the tensors the shading reads,
    None ignored) requires a gradient while grad mode is on, the estimator
    is naive, the sampler PCG, every type of the material set diffuse or
    emitter and the call not textured; else "ops", the torch ops of the
    step, which carry gradients, shadow rays and every material."""
    if device.type != "cuda":
        return "ops"
    if options.estimator != "naive" or options.rng != "pcg" or options.textured:
        return "ops"
    if not set(options.material_set) <= FUSED_MATERIALS:
        return "ops"
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in inputs):
        return "ops"
    return "fused"


def light_table(scene: TriangleScene):
    """The area-weighted light table over the live emitter triangles:
    ``(light_cdf, total_light_area)``, both float32. Areas and their prefix
    sums are taken in float64 and the CDF is rounded once, so it is the same
    on the CPU and the card: in float32 both the cross product's rounding
    and the cumsum's scan order differ between devices. The total is a
    plain float32 sum of the rounded areas."""
    tri_area = 0.5 * torch.linalg.norm(torch.linalg.cross(scene.e1.double(), scene.e2.double()), dim=-1)
    tri_is_light = (scene.materials.type[scene.mat_id] == BxdfType.EMITTER) & scene.valid
    light_w = tri_area * tri_is_light.to(torch.float64)
    return torch.cumsum(light_w, 0).float(), light_w.float().sum()


def _gather_materials(scene: TriangleScene, mat_id: torch.Tensor, textured: bool = False) -> dict:
    """Per-ray material attributes via one row gather of a packed table; the
    texture columns (kind, id, checker color and scale) ride along only when
    ``textured``."""
    m = scene.materials
    cols = [
        m.type.to(torch.float32)[:, None],
        m.albedo,
        m.specular_color,
        m.refractive_index[:, None],
        m.emissive_color,
        m.intensity[:, None],
        m.transmittance_color,
    ]
    if textured:
        cols += [
            m.tex_kind.to(torch.float32)[:, None],
            m.tex_id.to(torch.float32)[:, None],
            m.checker_color,
            m.checker_scale[:, None],
        ]
    g = torch.cat(cols, dim=-1).index_select(0, mat_id)  # backward: index_add_ (see resolve_hits)
    out = {
        "type": g[:, 0].to(torch.int64),
        "albedo": g[:, 1:4],
        "specular": g[:, 4:7],
        "ior": g[:, 7],
        "emissive": g[:, 8:11],
        "intensity": g[:, 11],
        "transmittance": g[:, 12:15],
    }
    if textured:
        out.update(
            tex_kind=g[:, 15].to(torch.int64),
            tex_id=g[:, 16].to(torch.int64),
            checker_color=g[:, 17:20],
            checker_scale=g[:, 20],
        )
    return out


@dataclasses.dataclass(frozen=True)
class PathState:
    """Wavefront state of R paths."""

    o: torch.Tensor  # (R, 3) ray origins
    d: torch.Tensor  # (R, 3) unit ray directions
    throughput: torch.Tensor  # (R, 3)
    radiance: torch.Tensor  # (R, 3)
    alive: torch.Tensor  # (R,) bool
    prev_nee: torch.Tensor  # (R,) bool — the previous vertex sampled a light
    prev_pdf: torch.Tensor  # (R,) float32 — its solid-angle BSDF pdf (MIS)
    keys: torch.Tensor  # (R, 4) PCG or (R, 2) threefry keys


def init_path_state(origins, directions, keys) -> PathState:
    r = origins.shape[0]
    dev = origins.device
    return PathState(
        o=origins,
        d=directions,
        throughput=torch.ones((r, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((r, 3), dtype=torch.float32, device=dev),
        alive=torch.ones((r,), dtype=torch.bool, device=dev),
        prev_nee=torch.zeros((r,), dtype=torch.bool, device=dev),  # the camera samples no light
        prev_pdf=torch.zeros((r,), dtype=torch.float32, device=dev),
        keys=keys,
    )


def dead_path_state(r: int, keys: torch.Tensor, device) -> PathState:
    """An inert state of ``r`` lanes on ``device``: no lane alive, so every
    bounce applied to it changes nothing. What a pipeline stage holds
    before its first microbatch arrives (``parallel/pipeline.py``)."""
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=device)
    return PathState(
        o=zeros(r, 3),
        d=torch.tensor([[0.0, 0.0, 1.0]], device=device).repeat(r, 1),
        throughput=zeros(r, 3),
        radiance=zeros(r, 3),
        alive=zeros(r, dtype=torch.bool),
        prev_nee=zeros(r, dtype=torch.bool),
        prev_pdf=zeros(r),
        keys=keys,
    )


def make_bounce_fn(
    scene: TriangleScene,
    options: IntegratorOptions,
    intersect_fn=None,
    packed=None,
    occlusion_kernel: bool = False,
):
    """Build the single-bounce step ``bounce(state, bounce_idx, compact_now=True)``.

    ``intersect_fn(o, d, alive=None) -> Hit`` defaults to the packed
    closest-hit search over ``packed``. ``occlusion_kernel`` answers NEE
    shadow rays with the any-hit search over ``packed`` instead of a
    thresholded closest hit; it cannot be combined with a caller's
    ``intersect_fn``. Per-lane results depend only on the lane's ray and
    key, so compaction does not change the image.
    """
    check_supported(options)
    if occlusion_kernel and intersect_fn is not None:
        raise ValueError("occlusion_kernel searches the pack, which would bypass the custom intersect_fn")
    if intersect_fn is None:
        if packed is None and options.intersector not in _UNPACKED_INTERSECTORS:
            packed = packed_intersect.pack_scene(scene, tri_block=options.tri_block)
        intersect_fn = make_intersect_fn(scene, options, packed=packed)
    sampler = make_sampler(options.rng)
    ms = tuple(options.material_set)
    has_emit = BxdfType.EMITTER in ms
    has_diffuse = BxdfType.DIFFUSE in ms
    has_mirror = BxdfType.MIRROR in ms
    has_glass = BxdfType.GLASS in ms
    # Light sampling needs an emitter to sample and a diffuse vertex to
    # sample from; without both the estimator is the naive one.
    nee = options.estimator in ("nee", "mis") and has_emit and has_diffuse
    mis = options.estimator == "mis" and nee
    textured = options.textured and has_diffuse
    mats = scene.materials
    scene_inputs = (scene.v0, scene.e1, scene.e2, mats.albedo, mats.emissive_color, mats.intensity)
    if options.use_shading_normals:
        scene_inputs += (scene.n0, scene.n1, scene.n2)

    if nee:
        occlude = make_occlusion_fn(scene, options, intersect_fn, packed=packed, use_kernel=occlusion_kernel)
        light_cdf, total_light_area = light_table(scene)

    compact = partial(compact_rays_coherent, key_mode=options.sort_key) if options.sort_rays else compact_rays
    # Mask mode hands the live mask to the searches; the sort needs the
    # physical permutation, so with sort_rays the bounces permute.
    mask_compact = options.compact and options.compact_mode == "mask" and not options.sort_rays

    def masked_intersect(o, d, mask, compact_now: bool) -> Hit:
        """Closest hit for lanes where ``mask`` holds; others report no hit."""
        if not (options.compact and compact_now):
            h = intersect_fn(o, d)
            return Hit(t=h.t, tri=h.tri, hit=h.hit & mask)
        if mask_compact:
            h = intersect_fn(o, d, alive=mask)
            return Hit(t=h.t, tri=h.tri, hit=h.hit & mask)
        with scope("render.compact"):
            o_c, d_c, inv = compact(o, d, mask)
        h = intersect_fn(o_c, d_c)
        with scope("render.compact"):
            return Hit(t=h.t[inv], tri=h.tri[inv], hit=h.hit[inv] & mask)

    def masked_occluded(o, d, max_t, mask):
        """Shadow query for lanes where ``mask`` holds (others report
        unoccluded). Dead lanes carry max_t = 0; in permute mode they are
        also permuted behind the live ones and parked outside the scene."""
        mt = torch.where(mask, max_t, 0.0)
        if not options.compact or mask_compact:
            return occlude(o, d, mt) & mask
        with scope("render.compact"):
            o_c, d_c, inv = compact_rays(o, d, mask)
            mt_c = torch.zeros_like(mt)
            mt_c[inv] = mt  # lane i moves to position inv[i]
        occ = occlude(o_c, d_c, mt_c)
        with scope("render.compact"):
            return occ[inv] & mask

    def bounce(state: PathState, bounce_idx: int, compact_now: bool = True) -> PathState:
        route = shade_route(options, state.o.device, (state.o, state.d, state.throughput, state.radiance,
                                                      *scene_inputs))
        # The ops route's background, made before the search is queued: on
        # the card this copy from host memory returns only once the work
        # queued before it has run, and after the search it would hold the
        # host back for the search's time. The fused route takes three floats.
        if route == "ops":
            background = torch.tensor(options.background, dtype=torch.float32, device=state.o.device)
        hit = masked_intersect(state.o, state.d, state.alive, compact_now)
        with scope("render.shade", SHADE_ROUTES.index(route)):
            if route == "fused":
                return shade_fused(state, hit, bounce_idx)
            return shade(state, hit, bounce_idx, background)

    def shade_fused(state: PathState, hit: Hit, bounce_idx: int) -> PathState:
        """``shade`` for the naive estimator in one kernel launch."""
        roulette = options.rr_start is not None and bounce_idx >= options.rr_start
        o, d, throughput, radiance, alive, prev_nee, prev_pdf = naive_shade(
            state.o, state.d, state.throughput, state.radiance, state.alive, hit, state.keys, scene,
            options.background, bounce_idx, has_emit, has_diffuse, options.use_shading_normals, roulette,
        )
        return PathState(o=o, d=d, throughput=throughput, radiance=radiance, alive=alive, prev_nee=prev_nee,
                         prev_pdf=prev_pdf, keys=state.keys)

    def shade(state: PathState, hit: Hit, bounce_idx: int, background: torch.Tensor) -> PathState:
        """The bounce after its closest hit: emission, light samples and
        the scatter."""
        o, d, throughput, radiance, alive = state.o, state.d, state.throughput, state.radiance, state.alive
        attrs = resolve_hits(o, d, scene, hit.tri, need_sn=options.use_shading_normals, need_uv=textured)
        found = alive & hit.hit
        missed = alive & ~hit.hit
        radiance = radiance + torch.where(missed[:, None], throughput * background[None, :], 0.0)

        mat = _gather_materials(scene, attrs.mat_id, textured=textured)
        if textured:
            albedo = textured_albedo(
                mat["albedo"], mat["tex_kind"], mat["tex_id"], mat["checker_color"], mat["checker_scale"],
                attrs.uv, scene.textures,
            )
        else:
            albedo = mat["albedo"]
        no_lanes = torch.zeros_like(found)
        is_emit = (mat["type"] == BxdfType.EMITTER) if has_emit else no_lanes
        is_diffuse = (mat["type"] == BxdfType.DIFFUSE) if has_diffuse else no_lanes
        is_mirror = (mat["type"] == BxdfType.MIRROR) if has_mirror else no_lanes
        is_glass = (mat["type"] == BxdfType.GLASS) if has_glass else no_lanes

        if has_emit:
            # EMITTER: two-sided Le = emissive * intensity; the path ends.
            # naive counts every hit; nee only hits whose previous vertex
            # sampled no light (its light sample already covered this one);
            # mis weights hits from a light-sampling vertex by
            # pdf_bsdf / (pdf_bsdf + pdf_light), the complement of the light
            # sample's weight below.
            le = mat["emissive"] * mat["intensity"][:, None]
            emitted = throughput * le
            count_emit = found & is_emit
            if mis:
                # The light sampler's solid-angle pdf of this hit:
                # t² / (cosθ_y · A_total).
                cos_y_hit = absolute((attrs.gn * d).sum(dim=-1))
                pdf_light_hit = attrs.t * attrs.t / maximum(cos_y_hit * total_light_area, 1e-12)
                w_bsdf = state.prev_pdf / maximum(state.prev_pdf + pdf_light_hit, 1e-12)
                emitted = emitted * torch.where(state.prev_nee, w_bsdf, 1.0)[:, None]
            elif nee:
                count_emit = count_emit & ~state.prev_nee
            radiance = radiance + torch.where(count_emit[:, None], emitted, 0.0)

        # Shading normal oriented against the incident ray.
        n = attrs.sn if options.use_shading_normals else attrs.gn
        facing = -torch.sign((d * n).sum(dim=-1, keepdim=True))
        n_shade = n * torch.where(facing == 0.0, 1.0, facing)

        kb = sampler.fold(state.keys, bounce_idx)
        u = sampler.uniform(kb, 3)

        if nee:
            with scope("render.nee"):
                # Next-event estimation: a point on an emitter, picked by area,
                # and a shadow ray to it; adds
                # throughput · (albedo/π) · Le · cosθ_x·cosθ_y / r² · A_total.
                ul = sampler.uniform(sampler.fold(kb, 0x11EE), 3)
                pick = torch.searchsorted(light_cdf, ul[:, 0] * total_light_area, right=True)
                pick = torch.clamp(pick, 0, scene.num_triangles - 1)
                su = torch.sqrt(ul[:, 1])
                b1 = su * (1.0 - ul[:, 2])
                b2 = su * ul[:, 2]
                rows = lambda x: x.index_select(0, pick)
                y = rows(scene.v0) + b1[:, None] * rows(scene.e1) + b2[:, None] * rows(scene.e2)
                # Missed lanes' resolved points are meaningless and may be huge.
                x = torch.where(found[:, None], attrs.point, o)
                wi_raw = y - x
                dist2 = maximum((wi_raw * wi_raw).sum(dim=-1), 1e-12)
                dist = torch.sqrt(dist2)
                wi = wi_raw / dist[:, None]
                cos_x = (n_shade * wi).sum(dim=-1)
                cos_y = absolute((rows(scene.gn) * wi).sum(dim=-1))  # two-sided lights
                # Visible iff nothing lies before the sampled point; the relative
                # epsilon keeps the light triangle out of its own shadow test.
                # Visibility is discrete: the shadow ray and its cutoff carry no
                # gradient (the JAX package detaches the same three).
                cutoff = dist.detach() * (1.0 - 1e-3)
                shadow_o = (x + RAY_OFFSET * n_shade).detach()
                lit = ~masked_occluded(shadow_o, wi.detach(), cutoff, found & is_diffuse)
                light_mat = scene.mat_id[pick]
                m = scene.materials
                le_y = m.emissive_color.index_select(0, light_mat) * m.intensity.index_select(0, light_mat)[:, None]
                geom = maximum(cos_x, 0.0) * cos_y / dist2 * total_light_area
                contrib = throughput * (albedo / math.pi) * le_y * geom[:, None]
                if mis:
                    # Balance heuristic against the cosine BSDF sampler.
                    pdf_light = dist2 / maximum(cos_y * total_light_area, 1e-12)
                    pdf_bsdf = maximum(cos_x, 0.0) / math.pi
                    contrib = contrib * (pdf_light / maximum(pdf_light + pdf_bsdf, 1e-12))[:, None]
                use = found & is_diffuse & lit & (total_light_area > 0)
                radiance = radiance + torch.where(use[:, None], contrib, 0.0)

        # The scatter selects, innermost first over the present types; each
        # type overrides its own lanes, and lanes that do not scatter keep
        # their ray.
        new_d = d
        tp_factor = torch.ones_like(albedo)
        if has_glass:
            # GLASS: reflect or refract, picked by Schlick's Fresnel term.
            # cos_i, entering and n_glass use the un-oriented normal.
            cos_i = clip(-(d * n).sum(dim=-1), -1.0, 1.0)
            entering = cos_i > 0.0
            n_glass = torch.where(entering[:, None], n, -n)
            eta_i = torch.where(entering, 1.0, mat["ior"])
            eta_t = torch.where(entering, mat["ior"], 1.0)
            fres = fresnel_schlick(absolute(cos_i), eta_i, eta_t)
            refr, tir = refract(d, n_glass, (eta_i / eta_t)[:, None])
            reflect_choice = tir | (u[:, 2] < fres)
            new_d = torch.where(reflect_choice[:, None], reflect(d, n_glass), normalize_dir(refr))
            tp_factor = torch.where(reflect_choice[:, None], torch.ones_like(albedo), mat["transmittance"])
        if has_mirror:
            # MIRROR: perfect specular reflection × the specular color.
            new_d = torch.where(is_mirror[:, None], reflect(d, n_shade), new_d)
            tp_factor = torch.where(is_mirror[:, None], mat["specular"], tp_factor)
        if has_diffuse:
            # DIFFUSE: cosine-weighted hemisphere sample; throughput × albedo.
            local = cosine_sample_hemisphere(u[:, 0], u[:, 1])
            new_d = torch.where(is_diffuse[:, None], local_to_world(local, n_shade), new_d)
            tp_factor = torch.where(is_diffuse[:, None], albedo, tp_factor)

        scatter = found & ~is_emit
        s = scatter[:, None]
        new_throughput = torch.where(s, throughput * tp_factor, throughput)
        # A refracted ray starts behind the surface, on the far side of n_glass.
        offset_n = n_shade
        if has_glass:
            offset_n = torch.where((is_glass & ~reflect_choice)[:, None], -n_glass, n_shade)

        alive_next = scatter
        if options.rr_start is not None and bounce_idx >= options.rr_start:
            # Russian roulette on the max channel of the new throughput; the
            # survivors are divided by their survival probability.
            p = clip(new_throughput.amax(dim=-1), 0.05, 1.0)
            ur = sampler.uniform(sampler.fold(kb, 7919), 1)[:, 0]
            survive = ur < p
            new_throughput = torch.where(survive[:, None], new_throughput / p[:, None], new_throughput)
            alive_next = alive_next & survive

        # Next bounce's emitter accounting: did this vertex sample a light
        # (diffuse vertices do; mirror and glass do not, so an emitter hit
        # after them counts whole), and with what pdf (cosθ/π) did it scatter.
        prev_nee = scatter & is_diffuse
        cos_scatter = maximum((new_d * n_shade).sum(dim=-1), 0.0)
        return PathState(
            o=torch.where(s, attrs.point + RAY_OFFSET * offset_n, o),
            d=torch.where(s, new_d, d),
            throughput=new_throughput,
            radiance=radiance,
            alive=alive_next,
            prev_nee=prev_nee,
            prev_pdf=torch.where(prev_nee, cos_scatter / math.pi, 0.0),
            keys=state.keys,
        )

    return bounce


def _permute_state(state: PathState, perm: torch.Tensor) -> PathState:
    return PathState(**{f.name: getattr(state, f.name).index_select(0, perm) for f in dataclasses.fields(state)})


def make_path_bounces(scene: TriangleScene, options: IntegratorOptions, intersect_fn=None, packed=None,
                      packed_secondary=None):
    """The two bounce steps a path takes, ``(first, later)``:
    ``first(state)`` applies bounce 0, uncompacted (every lane is alive and
    camera-coherent there, so compaction is pure overhead), on ``packed``
    or ``intersect_fn``, its shadow rays answered by a thresholded closest
    hit; ``later(state, b)`` applies bounce ``b`` ≥ 1, on
    ``packed_secondary`` with the any-hit search for its shadow rays when a
    second pack is given, else as bounce 0 but compacted. ``trace_paths``
    and the pipeline (``parallel/pipeline.py``) both take their bounces
    from here, so both answer every ray with the same search.

    ``packed_secondary`` replaces the intersector of the later bounces, so
    it cannot be combined with a custom ``intersect_fn``."""
    if packed_secondary is not None and intersect_fn is not None:
        raise ValueError("packed_secondary would replace the custom intersect_fn of the later bounces")
    bounce = make_bounce_fn(scene, options, intersect_fn=intersect_fn, packed=packed)
    later = bounce
    if packed_secondary is not None and options.bounces > 1:
        later = make_bounce_fn(scene, options, packed=packed_secondary, occlusion_kernel=True)
    return (lambda state: bounce(state, 0, compact_now=False)), later


def trace_paths(
    scene: TriangleScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    keys: torch.Tensor,
    options: IntegratorOptions,
    intersect_fn=None,
    packed=None,
    packed_secondary=None,
) -> torch.Tensor:
    """Trace R paths for ``options.bounces`` bounces; returns radiance (R, 3).

    ``packed_secondary``: a second pack of the same scene at another block
    width for bounces 1..N-1 (images do not depend on the block width).
    It replaces the intersector of those bounces, so it cannot be combined
    with a custom ``intersect_fn``.

    Shadow rays go through the any-hit search only on the bounces built
    from ``packed_secondary``; bounce 0, and every bounce without a second
    pack, thresholds the closest hit, as the JAX package's ``render_frame``
    does (its own intersect function turns the any-hit kernel off there).

    ``compact_mode="hybrid"`` permutes the whole path state alive-first
    once after bounce 0, runs the later bounces in mask mode and permutes
    the radiance back.
    """
    hybrid = options.compact and options.compact_mode == "hybrid" and options.bounces > 1
    if hybrid:
        options = dataclasses.replace(options, compact_mode="mask")
    first, later = make_path_bounces(scene, options, intersect_fn, packed, packed_secondary)
    state = init_path_state(origins, directions, keys)
    with scope("render.bounce"):
        state = first(state)
    inv = None
    if hybrid:
        with scope("render.compact"):
            perm, inv = partition_alive(state.alive)
            state = _permute_state(state, perm)
    for b in range(1, options.bounces):
        with scope("render.bounce"):
            state = later(state, b)
    if inv is None:
        return state.radiance
    with scope("render.compact"):
        return state.radiance.index_select(0, inv)


def normal_aov(
    scene: TriangleScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    options: IntegratorOptions,
    reference_parity: bool = True,
    intersect_fn=None,
) -> torch.Tensor:
    """The reference's shading: ``|world normal|`` on a hit, else 0, after
    one closest-hit search. ``reference_parity=True`` takes the
    unnormalised inverse-transpose normal ``gn_ref``; False the unit
    geometric normal."""
    if intersect_fn is None:
        intersect_fn = make_intersect_fn(scene, options)
    hit = intersect_fn(origins, directions)
    n = (scene.gn_ref if reference_parity else scene.gn).index_select(0, hit.tri.clamp(min=0))
    return torch.where(hit.hit[:, None], absolute(n), 0.0)
