"""Staged wavefront: bounce k runs on pipe stage k, and microbatches of rays
rotate through the stages.

Counterpart of ``gpupathtracer_tpu/parallel/pipeline.py`` over
``torch.distributed``, one process per stage on a ``("pipe",)`` mesh. The
path state (``render/integrator.PathState``) is what passes between the
stages, as the activations of a microbatched model pipeline do.

Schedule (S stages, M microbatches, T = M + S − 1 steps):

    step t: stage 0 loads microbatch t (t < M) and applies bounce 0;
            stage k applies bounce k to microbatch t − k;
            stage S − 1 writes microbatch t − S + 1's finished radiance;
            the states rotate k → k + 1 (``multihost.shift``), and stage 0
            replaces what arrives from the last stage by an inert state.

A stage that holds no microbatch at a step (t − k outside [0, M)) holds an
inert state (``dead_path_state``: no lane alive, so a bounce would change
nothing) and skips its bounce; the result is the same. Every stage still
shifts at every step: a step's point-to-point operations are one batch
around the ring, and a rank that left its part out would hang the others.
So stage k applies its bounce M times a sample.

Exactness: a lane's result depends only on its ray and its key (the
counter-based RNG is keyed by pixel, sample and bounce), and each stage
applies the bounce that ``trace_paths`` applies (``make_path_bounces``:
bounce 0 on the first pack, its shadow rays answered by a thresholded
closest hit; the later bounces on the second pack with the any-hit
search), so the frame equals ``render_frame``'s. ``compact_mode="hybrid"``
permutes the whole path state after bounce 0, which a microbatch cannot
carry from stage to stage; here it runs as "mask", which gives the same
image.

The transport detaches: states cross the ring by point-to-point operations
(and through the host under gloo), which carry no autograd history. The
pipeline runs under ``torch.no_grad()``; gradients go through
``render/renderer.render_frame`` or ``parallel/render.py``.

Scope: a structural demo, not a performance feature. It shows the schedule
and its exactness, but needs ``bounces == n_stages``. Path tracing has no
weight-residency motive for pipelining (the scene is replicated or sharded
by rows; the activations are the work), so data parallelism, with equal
rays per rank and no traffic between stages, is expected to win at every
scale. ``parallel/render.py`` is the renderer for real use.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gpupathtracer_tpu_torch.core.tensors import resolve_device
from gpupathtracer_tpu_torch.models.camera import Camera
from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops.sampling import prng_key_data
from gpupathtracer_tpu_torch.parallel.mesh import ensure_group, mesh_device_type
from gpupathtracer_tpu_torch.parallel.multihost import broadcast, shift
from gpupathtracer_tpu_torch.render.integrator import (
    IntegratorOptions,
    PathState,
    dead_path_state,
    init_path_state,
    make_path_bounces,
)
from gpupathtracer_tpu_torch.render.renderer import RenderSettings, _integrator_options, _prepare, sample_rays
from gpupathtracer_tpu_torch.utils.debug import check_frame


def make_pipe_mesh(n_pipe: int) -> DeviceMesh:
    """A one-axis ``("pipe",)`` mesh over ranks 0 … ``n_pipe`` − 1 of the
    process group; stage k is rank k. Every rank of the group calls it (it
    creates the axis's process group), also the ranks it leaves out. The
    device type is ``mesh.mesh_device_type``'s. Calls ``mesh.ensure_group``."""
    ensure_group()
    device_type = mesh_device_type()
    if not 1 <= n_pipe <= dist.get_world_size():
        raise ValueError(f"{n_pipe} pipe stages on {dist.get_world_size()} processes")
    return DeviceMesh(device_type, torch.arange(n_pipe), mesh_dim_names=("pipe",))


def _fields(state: PathState) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


@torch.no_grad()
def trace_paths_pipelined(
    scene: TriangleScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    keys: torch.Tensor,
    options: IntegratorOptions,
    mesh: DeviceMesh,
    microbatches: int = 4,
    packed=None,
    packed_secondary=None,
) -> torch.Tensor:
    """Radiance (R, 3) of R paths with bounce k applied on pipe stage k, on
    every rank of ``mesh`` (each rank passes the same rays and keys).
    Microbatch j is rays [j·R/M, (j+1)·R/M). ``packed`` and
    ``packed_secondary`` are ``trace_paths``'s.

    Raises ValueError unless ``options.bounces`` equals the stage count
    (one bounce per stage) and R divides by ``microbatches``: the JAX
    package's two asserts, as checks that also hold under ``-O``."""
    n_stages = mesh.size()
    if options.bounces != n_stages:
        raise ValueError(f"one bounce per pipe stage: bounces {options.bounces}, stages {n_stages}")
    r = origins.shape[0]
    if r % microbatches:
        raise ValueError(f"rays {r} not divisible by {microbatches} microbatches")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the pipe mesh {mesh.mesh.tolist()}")
    if options.compact_mode == "hybrid":
        options = dataclasses.replace(options, compact_mode="mask")
    k, group = mesh.get_local_rank("pipe"), mesh.get_group("pipe")
    first, later = make_path_bounces(scene, options, packed=packed, packed_secondary=packed_secondary)
    m, rmb = microbatches, r // microbatches
    device = origins.device
    state = dead_path_state(rmb, keys[:rmb], device)
    out = torch.zeros((r, 3), dtype=torch.float32, device=device)
    for t in range(m + n_stages - 1):
        mb = t - k  # the microbatch this stage holds at this step
        if 0 <= mb < m:
            rows = slice(mb * rmb, (mb + 1) * rmb)
            if k == 0:
                state = first(init_path_state(origins[rows], directions[rows], keys[rows]))
            else:
                state = later(state, k)
            if k == n_stages - 1:
                out[rows] = state.radiance
        state = PathState(**shift(_fields(state), group))
        if k == 0:  # retired work from the last stage: never bounce it again
            state = dead_path_state(rmb, state.keys, device)
    return broadcast(out, n_stages - 1, group)


def render_frame_pipelined(
    scene: TriangleScene,
    camera: Camera,
    settings: RenderSettings,
    mesh: DeviceMesh,
    seed: int | None = None,
    microbatches: int = 4,
    device="cuda",
) -> torch.Tensor:
    """The (H, W, 3) mean-radiance frame through the staged wavefront, on
    ``device`` (the card unless the caller passes ``device="cpu"``), on
    every rank of ``mesh``; every rank of the mesh calls it. Equal to
    ``render_frame``'s: the same narrowed settings and packs (``_prepare``),
    the same keys and jitter (``sample_rays``), the same bounce on every
    lane, the samples summed in the same order. Radiance only, and
    ``settings.bounces`` must equal the stage count."""
    if settings.aov != "radiance":
        raise ValueError(f"render_frame_pipelined renders radiance, not aov {settings.aov!r}")
    device = resolve_device(device)
    scene, camera, settings, packed, packed2 = _prepare(scene, camera, settings, device)
    opts = _integrator_options(settings)
    h, w = settings.height, settings.width
    pixel_idx = torch.arange(h * w, device=device)
    key_data = prng_key_data(settings.seed if seed is None else seed)
    film_sum = torch.zeros((h * w, 3), dtype=torch.float32, device=device)
    for s in range(settings.spp):
        o, d, keys = sample_rays(camera, pixel_idx, settings, key_data, s)
        film_sum = film_sum + trace_paths_pipelined(
            scene, o, d, keys, opts, mesh, microbatches=microbatches, packed=packed, packed_secondary=packed2
        )
    return check_frame((film_sum / settings.spp).reshape(h, w, 3), "render_frame_pipelined")
