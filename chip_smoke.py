"""Smoke run of the PyTorch + CUDA port (gpupathtracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
1. device: the card's name and power limit from nvidia-smi;
2. build: nvcc builds the four kernel sources of csrc/ from this checkout,
   all started together, with ptxas's registers and shared memory per
   kernel, and each kernel's launch shape at its ray tile (128 rays for K1
   and K2, 64 for K3 and K4) with its resident CTAs and warps per SM;
   (once per resident pack of the naive and NEE paths, on the card: w is
   zero outside the 25 live slots that every kernel reads, and finite)
3. the closest-hit kernel K1 against its plain PyTorch version at the naive
   path's shapes: 640,000 camera rays against the tri_block-128 pack and
   640,000 bounce-1 rays (traced with the plain version, compacted as the
   render does) against the tri_block-512 pack, with the hit parity bar and
   exact equality (the same packed rows and bit-equal t), the median time
   of each over 5 runs and the bound;
4. naive render_frame at 256x256, spp 2 through the kernels against the same
   render through the plain versions, with the image parity bar;
5. the naive path at full size (800x800, spp 4, 4 bounces): a finite image,
   exactly spp x bounces K1 launches and none of the others, the median
   frame time and rays/s (rays = W*H*spp*bounces) over 3 frames with varied
   seeds, and one more frame under torch.profiler split by kernel, with the
   device's idle share;
6. the any-hit kernel K2 against its plain version on the shadow rays that
   bounce 1 of the NEE path casts at 512x512 (bounce 0 traced with the plain
   version, the shadow rays compacted as the render does) against the
   tri_block-512 pack, with the flag bar and exact equality, the median
   time of each over 5 runs, the visited blocks and the bound;
7. NEE and MIS render_frame at 128x128, spp 2 through the kernels against
   the plain versions, with the image parity bar;
8. the NEE path at full width (512x512, spp 4, 3 bounces): a finite image,
   exactly spp x (bounces + 1) K1 and spp x (bounces - 1) K2 launches, the
   median frame time and rays/s over 3 frames with varied seeds, and one
   more frame under torch.profiler split by kernel, with the device's idle
   share;
then the streamed path, on a pack past the 16 MiB resident budget:
   (once per streamed pack, on the card: the live-slot check of phase 2 on
   the padded w that the streamed kernels get)
9. the streamed closest-hit kernel K3 against its plain version at the
   streamed path's shapes: 640,000 camera rays against the tri_block-256
   pack (64-ray tiles, 12 blocks per cluster) and 640,000 bounce-1 rays
   (traced with the plain version, coherent-compacted with the origin key as
   the render does) against the tri_block-1024 pack (3 blocks per cluster),
   with the hit bar, the median time of each over 5 runs, the computed
   blocks and the bound;
10. the split, measured: K1 on the same rays and packs with its own 128-ray
    tiles and block schedule (a diagnostic: which route is faster here);
11. the streamed any-hit kernel K4 against its plain version on the shadow
    rays that bounce 1 of the NEE path casts at 800x800, with the flag bar;
12. naive and NEE render_frame at 128x128, spp 2 through the kernels against
    the plain versions, with the image bar;
13. the streamed naive path (800x800, spp 2, 4 bounces): exactly spp x
    bounces K3 launches and none of the others, a finite image, the median
    frame time and rays/s over 3 frames, and one profiled frame;
14. the streamed NEE path (800x800, spp 1, 3 bounces): exactly
    spp x (bounces + 1) K3 and spp x (bounces - 1) K4 launches, and the
    frame time;
15. the light CDF of a scene with 1,200 emitter triangles is bit-equal on
    the card and the CPU;
and the differentiable path (the bench's loss, mean(image), in v0 and the
material albedo; the kernels run unchanged in every forward):
16. forward+backward at each full-size path's shapes, right after its
    forward frame (config 3 naive 800x800 spp 4, config 8 NEE 512x512 spp 4,
    config 6 streamed naive 800x800 spp 2, config 6 streamed NEE 800x800
    spp 1, 3 bounces, so that K4 too runs under autograd): the launches of
    each kernel in one
    fwd+bwd frame as in the forward, the peak device memory, finite
    gradients, the median time over 3 frames with varied seeds synchronised
    on one scalar of the gradients, fwd+bwd rays/s and the ratio to the
    forward frame;
17. gradients through the kernels against gradients through the plain
    versions, within rtol 1e-4 and atol 1e-6*max|g|: the config 8 stand-in
    at 128x128, spp 2 (K1 and K2) and config 5 at the trainer's shapes
    (96x96, spp 8, 2 bounces, NEE; K1);
18. the config 5 trainer (grad/inverse.py) at its defaults for 100 steps:
    the loss history, seconds per step, the recovered albedo's and vertex
    offsets' errors; the final loss must be below the first;
19. the pack cache on the card: an in-place edit of v0, then a render,
    equals a render on a fresh pack;
and the entry point with the render options it reaches (in the order they
run: 20-25 on the naive path, 26-27 on the NEE path, 28-30 on the streamed
path):
20. the CLI's progressive render of the config 3 stand-in (800x800, spp 4,
    chunks of 1 sample, a film checkpoint, the metrics stream, a PPM), in
    process: exactly 16 K1 launches and 4 chunk events, the PPM equal to
    to_u8(render_frame), render_progressive within atol 1e-6 of the frame,
    a resume from a film of 2 samples bit-identical, and the progressive
    wall time against the one-shot frame's;
21. K1 on the uncompacted bounce-1 rays with the live mask as alive (what
    compact_mode "mask" hands it: dead lanes inside tiles), exactly equal
    to its plain version, its time beside the compacted call's and the
    share of dead lanes;
22. the naive frame in compact_mode permute, mask and hybrid: launches,
    median of 3 frame times, one profiled frame each, and the mask and
    hybrid images against permute's (the image bar, and the count of
    differing pixels);
23. the normal AOVs at 800x800: exactly one K1 launch each and the plain
    version's image exactly;
24. glass and mirror (the config 3 stand-in with a two-sided glass body and
    a mirror floor, built in code): 128x128 spp 2 through the kernels
    against the plain versions (naive, rr_start 2; NEE and MIS with the
    floor left diffuse), and the naive frame at 800x800, spp 4: exactly 16
    K1 launches, the median of 3 frame times and rays/s;
25. live_view at 800x800 (chunks of 2 up to 4 samples, a camera command
    after the first chunk restarts accumulation), the CLI's turntable
    (2 frames) and the CLI's config 5 trainer (3 steps), with their K1
    launches;
26. K2 on the uncompacted shadow rays of bounce 1 (max_t = 0 on the dead
    lanes), exactly equal to its plain version;
27. the NEE frame in the three compaction modes, as 22;
28. K3 on the config 6 stand-in's uncompacted bounce-1 rays, as 21;
29. K4 on its uncompacted shadow rays, as 26;
30. the streamed naive frame in the three modes, as 22, with the origin
    sort the route resolves (which turns mask mode into permute) and with
    the sort off (mask mode hands K3 its dead lanes);
and the boundary gradient (grad/edges.py) with what it brought:
31. value_and_grad_with_edges on the config 3 stand-in (800x800, spp 4, 4
    bounces, naive; the parameter scales the body's vertices, the target
    is the render at scale 0.95, the loss the mean squared difference;
    1,024 edge samples, 4 trace samples): K1 launches of one call as
    expected, peak memory, the median of 3 calls with varied keys, one
    profiled call split by the function's own spans (the interior fwd+bwd,
    the primary and shadow boundary terms: host seconds and the device
    time of the work each launched), the packing every call repeats, the
    edge count, the boundary term's share of the gradient (against the
    detached gradient), and the gradient through the plain versions with
    the same key (rtol 1e-4);
32. the same on the config 8 stand-in (512x512, NEE) with the shadow term
    (512 samples): K1 and K2 launches;
33. the config 6 stand-in's edges: build_edge_table and
    build_edge_clusters seconds, and one shadow_edge_gradient call at 512
    samples on the streamed packs (3 K3 launches), then the same call
    profiled (the hierarchical picker's span ran once) and through the
    plain versions with the same key and clusters (rtol 1e-4);
34. the silhouette and camera demos' first step (64x64, spp 16, blocks of
    8) through the kernels and through the plain versions with the same key
    (loss to rtol 1e-6, gradient to rtol 1e-4); the demos at their defaults
    (40 and 60 steps, through K1): recovered errors, the detached gradient
    at the start (exactly 0), seconds per step; the CLI's invert --mode
    silhouette and camera (4 steps, spp 4);
35. the config 3 stand-in's naive frame with rng="threefry" (800x800,
    spp 4) through the kernels against the plain versions (the image bar),
    and its frame time beside the PCG frame's, in turns;
then the total wall time, a JSON line that summarises the four kernels, and
a JSON result line last.

The naive path renders scenes/config3_icosphere.toml, the NEE path
scenes/config8_icosphere.toml and the streamed path
scenes/config6_icosphere.toml: configs 3, 8 and 6 with their OBJ meshes
replaced by icospheres, so the run needs no asset files. Config 5 is built
in code (grad/inverse.py) or read from scenes/config5_invert_target.toml.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.grad.inverse import _demo_setup, camera_problem, run_inverse_demo, silhouette_problem
from gpupathtracer_tpu_torch.models.camera import generate_rays_for_pixels
from gpupathtracer_tpu_torch.models.materials import BxdfType
from gpupathtracer_tpu_torch.models.obj import MeshData
from gpupathtracer_tpu_torch.models.scene import build_scene, mesh_spec, plane_spec, sphere_spec
from gpupathtracer_tpu_torch.ops import _build, packed_intersect
from gpupathtracer_tpu_torch.ops.compaction import compact_rays, compact_rays_coherent
from gpupathtracer_tpu_torch.ops.packed_intersect import (
    DEFAULT_RAY_TILE,
    STREAM_RAY_TILE,
    closest_hit,
    closest_hit_reference,
    closest_hit_streamed,
    closest_hit_streamed_reference,
    is_resident,
    occluded,
    occluded_reference,
    occluded_streamed,
    occluded_streamed_reference,
    pack_scene,
    prepare_rays,
    prepare_rays_streamed,
)
from gpupathtracer_tpu_torch.ops.plucker import K, LIVE_SLOTS, NSCALARS
from gpupathtracer_tpu_torch.ops.sampling import PcgSampler, prng_key_data
from gpupathtracer_tpu_torch.render.integrator import (
    IntegratorOptions,
    init_path_state,
    light_table,
    make_bounce_fn,
)
from gpupathtracer_tpu_torch.render.film import to_u8
from gpupathtracer_tpu_torch.render.live import live_view
from gpupathtracer_tpu_torch.render.progressive import render_progressive
from gpupathtracer_tpu_torch.render.renderer import narrow_settings, render_frame, render_samples
from gpupathtracer_tpu_torch.utils import checkpoint as ckpt
from gpupathtracer_tpu_torch.utils.config import load_config, load_scene_file, parse_config
from gpupathtracer_tpu_torch.utils.image import read_ppm
from gpupathtracer_tpu_torch.utils.metrics import read_events

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "scenes", "config3_icosphere.toml")
NEE_SCENE = os.path.join(ROOT, "scenes", "config8_icosphere.toml")
STREAM_SCENE = os.path.join(ROOT, "scenes", "config6_icosphere.toml")
CONFIG5_SCENE = os.path.join(ROOT, "scenes", "config5_invert_target.toml")
KERNELS = {
    "closest_hit": {
        "source": "gpupathtracer_tpu_torch/csrc/closest_hit.cu",
        "replaces": "gpupathtracer_tpu/ops/pallas_intersect.py:496",
        "counter": closest_hit,
    },
    "occluded": {
        "source": "gpupathtracer_tpu_torch/csrc/occlusion.cu",
        "replaces": "gpupathtracer_tpu/ops/pallas_intersect.py:882",
        "counter": occluded,
    },
    "closest_hit_streamed": {
        "source": "gpupathtracer_tpu_torch/csrc/closest_hit_streamed.cu",
        "replaces": "gpupathtracer_tpu/ops/pallas_intersect.py:647",
        "counter": closest_hit_streamed,
    },
    "occluded_streamed": {
        "source": "gpupathtracer_tpu_torch/csrc/occlusion_streamed.cu",
        "replaces": "gpupathtracer_tpu/ops/pallas_intersect.py:960",
        "counter": occluded_streamed,
    },
}

# The least time the card could take (H100 SXM data sheet, dense, at the
# 700 W limit): f32 outside the tensor cores, the precision the parity bar
# needs, and device memory.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Per (lane, triangle column) of a visited block: one multiply and one add
# for each of the 25 (scalar, feature row) slots that a packed column can
# hold nonzero. The other 55 are structural zeros, and the bound counts what
# these inputs need, as for a sparse product, not the dense 5 x 16 product.
FLOP_PER_PAIR = 2 * len(LIVE_SLOTS)

# Parity bars of the reference's own on-chip tests (tests_tpu/test_onchip.py).
HIT_AGREE = 0.9995  # share of rays with the same winning triangle
T_TOL = 1e-5  # rtol = atol on t where the triangle agrees
IMG_MEAN = 2e-3  # mean |diff|
IMG_PIXEL = 3e-2  # a pixel is "off" above this max-channel |diff| ...
IMG_OFF_SHARE = 5e-3  # ... and fewer than this share may be off
# Gradients through the kernels against the plain versions (tests/test_torch_grad.py's tolerance).
GRAD_RTOL = 1e-4
GRAD_ATOL_OF_MAX = 1e-6


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn, device: torch.device, reps: int = 5) -> float:
    """Median wall time of ``fn()`` in ms over ``reps`` runs after one
    warm-up, synchronising before and after each run."""
    fn()
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device: torch.cuda.is_available() is False")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def ptxas_usage(report: str) -> dict:
    """ptxas's "Used ..." line of each kernel entry in an nvcc -Xptxas -v
    report, by mangled entry name."""
    usage, entry = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "Used" in ln and entry is not None:
            usage[entry] = ln.split("info    :")[-1].strip()
    return usage


def phase_build() -> None:
    t0 = time.perf_counter()
    reports = _build.build()
    for name in reports:
        _build.library(name)
    dt = time.perf_counter() - t0
    parts = []
    for name, report in reports.items():
        usage = " ".join(ln.split("info    :")[-1].strip() for ln in report.splitlines() if "Used" in ln)
        parts.append(f"{os.path.relpath(_build.source(name), ROOT)} -> "
                     f"{os.path.relpath(_build.library_path(name), ROOT)} ({usage})")
    print(f"build: nvcc, {len(reports)} sources in parallel, {dt:.2f} s: " + "; ".join(parts), flush=True)
    for name in _build.OCCUPANCY:
        ray_tile = STREAM_RAY_TILE if name.endswith("_streamed") else DEFAULT_RAY_TILE
        occ = packed_intersect.launch_occupancy(name, ray_tile)
        # K1 and K3 are templates on rays a thread: their entries' names carry ILi<rpt>E.
        used = [u for e, u in ptxas_usage(reports[name]).items()
                if "ILi" not in e or f"ILi{occ['rays_per_thread']}E" in e]
        occ["ptxas"] = "; ".join(used)
        print(f"occupancy {name}: {json.dumps(occ)}", flush=True)


def phase_live_zeros(label: str, packed) -> None:
    """The w that the kernels get from this pack (the pack's own on the
    resident route, padded to whole clusters on the streamed one) is exactly
    zero outside LIVE_SLOTS and finite everywhere (they read only the live
    slots); checked on the pack's device, once per pack."""
    route = "resident" if is_resident(packed) else "streamed"
    w = packed.w if route == "resident" else packed_intersect._stream_pack(packed)[0].w
    nb, tb = w.shape[0], w.shape[2] // NSCALARS
    row = {"blocks": nb, "tri_block": tb, "slots_outside": K * NSCALARS - len(LIVE_SLOTS),
           "nonzero_outside": int((packed_intersect.outside_live_slots(w) != 0).sum()),
           "finite": bool(torch.isfinite(w).all())}
    print(f"live slots, {route} pack {label} (bar: nonzero_outside = 0, finite): {json.dumps(row)}", flush=True)
    if row["nonzero_outside"] or not row["finite"]:
        raise AssertionError(f"the {route} pack {label} breaks the live-slot contract: {row}")


def bound(flop: float, nbytes: float) -> dict:
    """The least time for ``flop`` f32 operations moving ``nbytes``, and
    which of the two bounds it."""
    t_ops, t_bytes = flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {
        "flop": flop, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def sample0_bounce0(scene, camera, settings, packed):
    """Sample 0's camera rays and the path state after bounce 0, traced with
    the plain version; also the options of that trace."""
    device = scene.v0.device
    pixel_idx = torch.arange(camera.width * camera.height, device=device)
    keys = PcgSampler.path_keys(prng_key_data(settings.seed), pixel_idx, 0)
    jitter = PcgSampler.uniform(PcgSampler.fold(keys, 0xA11A), 2)
    o, d = generate_rays_for_pixels(camera, pixel_idx, jitter)
    narrowed = narrow_settings(scene, settings)
    opts = IntegratorOptions(
        bounces=settings.bounces, estimator=settings.estimator, material_set=narrowed.material_set,
        textured=narrowed.textured, intersector="plucker", sort_rays=narrowed.sort_rays,
        sort_key=narrowed.sort_key,
    )
    state = make_bounce_fn(scene, opts, packed=packed)(init_path_state(o, d, keys), 0, compact_now=False)
    return (o, d), state, opts


def main_path_rays(scene, camera, settings, packed):
    """Sample 0's camera rays, and the rays of bounce 1 after bounce 0 was
    traced with the plain version and compacted as the scan bounces are."""
    (o, d), state, opts = sample0_bounce0(scene, camera, settings, packed)
    if opts.sort_rays:
        o2, d2, _ = compact_rays_coherent(state.o, state.d, state.alive, key_mode=opts.sort_key)
    else:
        o2, d2, _ = compact_rays(state.o, state.d, state.alive)
    return (o, d), (o2, d2)


def nee_shadow_inputs(scene, camera, settings, packed, packed2, plain_name: str, mask_mode: bool = False):
    """The any-hit inputs of the shadow rays that bounce 1 casts, as the
    render builds them (compacted, padded, culled and scheduled), taken from
    a plain-version trace by catching the call of ``plain_name``. With
    ``mask_mode``, as compact_mode "mask" casts them: uncompacted, with
    max_t = 0 on the dead lanes (ray sorting off, which mask mode needs)."""
    _, state, opts = sample0_bounce0(scene, camera, settings, packed)
    if mask_mode:
        opts = dataclasses.replace(opts, compact_mode="mask", sort_rays=False)
    bounce1 = make_bounce_fn(scene, opts, packed=packed2, occlusion_kernel=True)
    captured = []
    plain = getattr(packed_intersect, plain_name)

    def capture(*args):
        captured.append(args)
        return plain(*args)

    # The search is looked up when it is called.
    setattr(packed_intersect, plain_name, capture)
    try:
        bounce1(state, 1)
    finally:
        setattr(packed_intersect, plain_name, plain)
    if len(captured) != 1:
        raise AssertionError(f"bounce 1 cast {len(captured)} shadow-ray batches through {plain_name}, expected 1")
    return captured[0]


def hit_check(name: str, label: str, kernel, plain, args, packed, reps: int = 5, exact: bool = False) -> dict:
    """A closest-hit kernel against its plain version on the same inputs;
    ``exact`` also requires the same packed row and a bit-equal t on every
    lane."""
    device = args[0].device
    bt_k, bi_k = kernel(*args)
    bt_r, bi_r, work = plain(*args, count_work=True)
    _sync(device)
    tri_map = lambda bi: torch.where(bi >= 0, packed.tri_map[bi.long().clamp(min=0)], -1)
    tri_k, tri_r = tri_map(bi_k), tri_map(bi_r)
    agree = (tri_k == tri_r).double().mean().item()
    same = (tri_k == tri_r) & (bi_r >= 0)
    err = (bt_k[same] - bt_r[same]).abs()
    max_abs_err = err.max().item() if err.numel() else 0.0
    t_ok = bool((err <= T_TOL + T_TOL * bt_r[same].abs()).all())
    same_row = (bi_k == bi_r).double().mean().item()
    t_equal = bool(torch.equal(bt_k, bt_r))
    kernel_ms = median_ms(lambda: kernel(*args), device, reps)
    plain_ms = median_ms(lambda: plain(*args), device, reps)
    b = bound(FLOP_PER_PAIR * work["lane_blocks"] * packed.tri_block, _nbytes(*args, bt_k, bi_k))
    ray_tile = args[-1]
    row = {
        "rays": args[-4].shape[0], "tri_block": packed.tri_block,
        "ray_tile": ray_tile, "blocks_per_schedule_entry": args[-2].shape[0] // args[0].shape[1],
        "hit_share": (bi_r >= 0).double().mean().item(), "same_tri": agree, "max_abs_err": max_abs_err,
        "same_row": same_row, "t_equal": t_equal,
        "ms": kernel_ms, "plain_ms": plain_ms, "visited_blocks": work["blocks"],
        "lane_blocks": work["lane_blocks"], **b,
    }
    bar = f"same_tri >= {HIT_AGREE}, |dt| <= {T_TOL} + {T_TOL}|t|"
    bar += "; exact: same_tri = same_row = 1, max_abs_err = 0, t_equal" if exact else ""
    print(f"{name} {label} (bar: {bar}): {json.dumps(row)}", flush=True)
    if agree < HIT_AGREE or not t_ok:
        raise AssertionError(f"{name} {label} misses the hit parity bar: same_tri {agree}, t ok {t_ok}")
    if exact and not (agree == 1.0 and same_row == 1.0 and max_abs_err == 0.0 and t_equal):
        raise AssertionError(f"{name} {label} is not exact: same_tri {agree}, same_row {same_row}, "
                             f"max_abs_err {max_abs_err}, t_equal {t_equal}")
    return row


def phase_kernel_check(label: str, o, d, packed) -> dict:
    """K1 against closest_hit_reference at its main-path shapes."""
    args = prepare_rays(o, d, packed) + (packed.w, DEFAULT_RAY_TILE)
    return hit_check("closest_hit", label, closest_hit, closest_hit_reference, args, packed, exact=True)


def phase_streamed_check(label: str, o, d, packed) -> dict:
    """K3 against closest_hit_streamed_reference at its main-path shapes."""
    if is_resident(packed):
        raise AssertionError(f"the streamed check needs a pack past the resident budget ({label})")
    args = prepare_rays_streamed(o, d, packed) + (STREAM_RAY_TILE,)
    return hit_check("closest_hit_streamed", label, closest_hit_streamed, closest_hit_streamed_reference, args, packed)


def phase_split(label: str, o, d, packed, k3_row: dict) -> dict:
    """K1 with its own 128-ray tiles and block schedule on the rays and pack
    K3 ran on: time and the share of rays with the same packed row."""
    device = o.device
    args = prepare_rays(o, d, packed) + (packed.w, DEFAULT_RAY_TILE)
    _, bi1 = closest_hit(*args)
    _, bi3 = closest_hit_streamed(*prepare_rays_streamed(o, d, packed), STREAM_RAY_TILE)
    ms = median_ms(lambda: closest_hit(*args), device)
    row = {"k1_ms": ms, "k3_ms": k3_row["ms"], "k1_over_k3": ms / k3_row["ms"],
           "same_row": (bi1[: o.shape[0]] == bi3[: o.shape[0]]).double().mean().item()}
    print(f"split {label}: K1 (128-ray tiles, block schedule) vs K3 (64-ray tiles, cluster schedule), "
          f"tri_block {packed.tri_block}: {json.dumps(row)}", flush=True)
    return row


def occlusion_check(name: str, label: str, kernel, plain, args, reps: int = 5, exact: bool = False) -> dict:
    """An any-hit kernel against its plain version on the same inputs;
    ``exact`` requires every flag equal."""
    feats, maxt, w = args[-4], args[-3], args[-2]
    device = feats.device
    occ_k = kernel(*args)
    occ_r, work = plain(*args, count_work=True)
    _sync(device)
    agree = (occ_k == occ_r).double().mean().item()
    dead_occluded = int((occ_k[maxt == 0] != 0).sum())
    kernel_ms = median_ms(lambda: kernel(*args), device, reps)
    plain_ms = median_ms(lambda: plain(*args), device, reps)
    tb = w.shape[2] // NSCALARS
    b = bound(FLOP_PER_PAIR * work["lane_blocks"] * tb, _nbytes(*args, occ_k))
    row = {
        "rays": feats.shape[0], "live_rays": int((maxt > 0).sum()), "tri_block": tb, "ray_tile": args[-1],
        "occluded_share": (occ_r > 0).double().mean().item(), "same_flag": agree,
        "dead_lanes_occluded": dead_occluded, "max_abs_err": (occ_k - occ_r).abs().max().item(),
        "ms": kernel_ms, "plain_ms": plain_ms,
        "visited_blocks": work["blocks"], "lane_blocks": work["lane_blocks"], **b,
    }
    bar = f"same_flag >= {HIT_AGREE}, no maxt = 0 lane occluded" + ("; exact: same_flag = 1" if exact else "")
    print(f"{name} {label} (bar: {bar}): {json.dumps(row)}", flush=True)
    if agree < HIT_AGREE or dead_occluded or (exact and agree != 1.0):
        raise AssertionError(f"{name} misses the flag bar: same_flag {agree}, {dead_occluded} dead lanes occluded")
    return row


def phase_image_check(scene, camera, settings, size: int, spp: int, label: str = "") -> None:
    """render_frame through the kernels against render_frame through the
    plain versions."""
    cam = dataclasses.replace(camera, width=size, height=size)
    st = dataclasses.replace(settings, width=size, height=size, spp=spp)
    img_k = render_frame(scene, cam, st)
    row = image_diff(img_k, render_frame(scene, cam, dataclasses.replace(st, intersector="plucker")))
    print(
        f"render {label}{st.estimator} {size}x{size} spp {spp}: kernels vs plain mean|diff| {row['mean_abs_diff']:.3e} "
        f"(bar < {IMG_MEAN}), max|diff| {row['max_abs_diff']:.3e}, pixels off by > {IMG_PIXEL}: {row['off_share']:.3e} "
        f"(bar < {IMG_OFF_SHARE}), image mean {img_k.mean().item():.6f}",
        flush=True,
    )
    if not meets_image_bar(row):
        raise AssertionError("render misses the image parity bar")


def image_diff(got, want) -> dict:
    """The image bar's numbers for ``got`` against ``want``, and the count
    of pixels that differ at all."""
    diff = (got - want).abs()
    return {"mean_abs_diff": diff.mean().item(), "max_abs_diff": diff.max().item(),
            "off_share": (diff.amax(dim=-1) > IMG_PIXEL).double().mean().item(),
            "pixels_differ": int((diff.amax(dim=-1) > 0).sum()), "finite": bool(torch.isfinite(got).all())}


def meets_image_bar(row: dict) -> bool:
    return row["finite"] and row["mean_abs_diff"] < IMG_MEAN and row["off_share"] < IMG_OFF_SHARE


def profile_frame(run, trace_path: str | None = None, top: int = 0) -> dict:
    """``run()`` once under torch.profiler: its wall time, the device's busy
    time (the union of the kernel intervals), launches and idle share of
    that wall time, and the device time of each of the four kernels and of
    all else; with ``top``, also the ``top`` costliest kernel names, and
    with ``trace_path``, the Chrome trace written there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of the kernel intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3, "device_launches": len(spans)}
    knames = ("closest_hit_kernel", "occlusion_kernel", "closest_hit_streamed_kernel", "occlusion_streamed_kernel")
    for kname in knames:
        out[f"{kname}_ms"] = sum(v for k, v in by_name.items() if kname in k)
    out["other_device_ms"] = sum(by_name.values()) - sum(out[f"{k}_ms"] for k in knames)
    out["idle_share_profiled"] = 1.0 - out["device_busy_ms"] / wall_ms if spans else None
    if top:
        out["top_kernels_ms"] = [[k[:120], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return out


def span_times(run, names) -> dict:
    """``run()`` once under torch.profiler, split by the record_function
    spans in ``names``: for each, how often it ran, its host seconds, and
    the device seconds and count of the kernels, copies and fills launched
    inside it (a launch belongs to a span when its runtime call lies in the
    span's host interval; the backward's launches come from autograd's
    threads while the span waits for them). Also the call's wall and all
    its device seconds. Read from the exported Chrome trace, which joins
    each device event to its launch by the correlation id."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    out = {"wall_s": wall, "device_s": sum(e["dur"] for e in device) / 1e6}
    for name in names:
        own = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "user_annotation" and e["name"] == name]
        at = lambda e: launched.get(e.get("args", {}).get("correlation"), float("nan"))
        inside = [e for e in device if any(a <= at(e) <= b for a, b in own)]
        out[name] = {"count": len(own), "host_s": sum(b - a for a, b in own) / 1e6,
                     "device_s": sum(e["dur"] for e in inside) / 1e6, "device_ops": len(inside)}
    return out


def expect_launches(**counts) -> dict:
    """Expected launches per kernel in one frame; kernels not named: 0."""
    return {name: counts.get(name, 0) for name in KERNELS}


def phase_full_frame(label: str, scene, camera, settings, expect: dict, frames: int = 3, profiled: bool = False) -> dict:
    """A path at full size: launches of each kernel in one frame (the counts
    set to 0 just before it), a finite image, frame time; optionally one more
    frame under the profiler."""
    device = scene.v0.device
    for k in KERNELS.values():
        k["counter"].launches = 0
    img = render_frame(scene, camera, settings)
    _sync(device)
    launches = {name: k["counter"].launches for name, k in KERNELS.items()}
    mean = img.mean().item()
    if launches != expect:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expect}")
    if tuple(img.shape) != (settings.height, settings.width, 3):
        raise AssertionError(f"{label}: full frame has shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or not 0.0 < mean < 10.0:
        raise AssertionError(f"{label}: full frame not finite or mean {mean} outside (0, 10)")
    times = []
    for i in range(frames):
        _sync(device)
        t0 = time.perf_counter()
        float(render_frame(scene, camera, settings, seed=1000 + i).sum())
        times.append(time.perf_counter() - t0)
    frame_s = statistics.median(times)
    rays = settings.width * settings.height * settings.spp * settings.bounces
    out = {"launches": launches, "image_mean": mean, "frame_s": frame_s, "frame_s_all": times,
           "rays_per_s": rays / frame_s}
    if profiled:
        out["profile"] = profile_frame(lambda: float(render_frame(scene, camera, settings, seed=999).sum()))
    shadow = " (shadow rays not counted)" if settings.estimator != "naive" else ""
    print(
        f"frame, {label} path, {settings.width}x{settings.height} spp {settings.spp} "
        f"bounces {settings.bounces}, rays = W*H*spp*bounces{shadow}: {json.dumps(out)}",
        flush=True,
    )
    return out


def many_lights_scene(device):
    """A floor and a sphere under 1,200 random emitter triangles (areas over
    three decades), made from seed 21."""
    rng = np.random.default_rng(21)
    n = 1200
    centers = np.stack([rng.uniform(-3, 3, n), rng.uniform(3.0, 4.0, n), rng.uniform(-3, 3, n)], axis=1)
    size = 10.0 ** rng.uniform(-2.0, -0.5, n)
    tris = (centers[:, None, :] + rng.normal(size=(n, 3, 3)) * size[:, None, None]).astype(np.float32)
    mesh = MeshData(vertices=tris, normals=np.zeros_like(tris), uvs=np.zeros((n, 3, 2), np.float32))
    materials = [{"type": "diffuse", "albedo": (0.7, 0.6, 0.5)},
                 {"type": "emitter", "emissive_color": (1.0, 0.9, 0.8), "intensity": 5.0}]
    specs = [plane_spec((0.0, -1.0, 0.0), (90.0, 0.0, 0.0), (20.0, 20.0, 20.0)),
             sphere_spec(radius=1.0, subdivisions=2), mesh_spec(mesh, mat_id=1, two_sided=True)]
    return build_scene(specs, materials, pad_to_multiple=128, device=device)


def phase_light_cdf(device) -> None:
    """The light CDF of one scene's tensors is bit-equal on the card and the
    CPU. Also counts, on the same tensors, the entries where the float32
    areas and a float32 cumsum of them differ between the two devices."""
    scene = many_lights_scene(device)
    host = scene.to("cpu")
    cdf_gpu, total_gpu = light_table(scene)
    cdf_cpu, total_cpu = light_table(host)
    differ = int((cdf_gpu.cpu() != cdf_cpu).sum())

    def f32_table(s):
        area = 0.5 * torch.linalg.norm(torch.linalg.cross(s.e1, s.e2), dim=-1)
        return area, torch.cumsum(area * (s.materials.type[s.mat_id] == BxdfType.EMITTER).float(), 0)

    area_g, cum_g = f32_table(scene)
    area_c, cum_c = f32_table(host)
    built_cpu = many_lights_scene("cpu")
    row = {
        "entries": cdf_cpu.numel(), "cdf_entries_differ": differ,
        "total_card": total_gpu.item(), "total_cpu": total_cpu.item(),
        "f32_areas_differ": int((area_g.cpu() != area_c).sum()),
        "f32_cumsum_differ": int((cum_g.cpu() != cum_c).sum()),
        "e1_differ_card_vs_cpu_build": int((scene.e1.cpu() != built_cpu.e1).any(dim=-1).sum()),
    }
    print(f"light CDF, 1,200 emitters, same scene tensors on card and CPU (bar: cdf_entries_differ = 0): "
          f"{json.dumps(row)}", flush=True)
    if differ:
        raise AssertionError(f"the light CDF differs between card and CPU in {differ} entries")


def _leaf_scene(scene):
    """The scene with ``v0`` and the material albedo as fresh leaves that
    require a gradient: ``(scene, (v0, albedo))``."""
    v0 = scene.v0.detach().clone().requires_grad_()
    albedo = scene.materials.albedo.detach().clone().requires_grad_()
    leaf = dataclasses.replace(scene, v0=v0, materials=dataclasses.replace(scene.materials, albedo=albedo))
    return leaf, (v0, albedo)


def bench_loss_grads(scene, leaves, camera, settings, seed=None):
    """The bench's loss, mean(image) (``gpupathtracer_tpu/bench.py``), and
    its gradients in (v0, albedo); zeros where no gradient reaches (the
    naive estimator's v0)."""
    loss = render_frame(scene, camera, settings, seed=seed).mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]


def _launch_counts() -> dict:
    return {name: k["counter"].launches for name, k in KERNELS.items()}


def _reset_launches() -> None:
    for k in KERNELS.values():
        k["counter"].launches = 0


def phase_grad_check(label: str, scene, camera, settings, expect: dict) -> dict:
    """Gradients of the bench loss in (v0, albedo) through the kernels and
    through the plain versions (intersector "plucker"): the hits are the
    same, so they agree within rtol 1e-4 and atol 1e-6*max|g| (only the
    order of the scatter-adds backwards differs). Also the kernel launches
    of the kernel run, as expected."""
    leaf, leaves = _leaf_scene(scene)
    _reset_launches()
    loss_k, g_k = bench_loss_grads(leaf, leaves, camera, settings)
    _sync(scene.v0.device)
    launches = _launch_counts()
    loss_p, g_p = bench_loss_grads(leaf, leaves, camera, dataclasses.replace(settings, intersector="plucker"))
    row = {"launches": launches, "loss": loss_k.item(), "loss_plain": loss_p.item()}
    ok = launches == expect and bool(torch.isfinite(loss_k)) and abs(loss_k.item() - loss_p.item()) <= 1e-6 * abs(loss_p.item())
    for name, a, b in zip(("v0", "albedo"), g_k, g_p):
        scale = b.abs().max().item()
        diff = (a - b).abs()
        bad = int((diff > GRAD_RTOL * b.abs() + GRAD_ATOL_OF_MAX * scale).sum())
        finite = bool(torch.isfinite(a).all())
        row[name] = {"max_abs_g": scale, "max_abs_diff": diff.max().item(), "entries": a.numel(),
                     "nonzero": int((b != 0).sum()), "outside_tolerance": bad, "finite": finite}
        ok = ok and bad == 0 and finite
    print(f"gradients, kernels vs plain, {label} {settings.width}x{settings.height} spp {settings.spp} "
          f"bounces {settings.bounces} {settings.estimator} (bar: outside_tolerance = 0 at rtol {GRAD_RTOL}, "
          f"atol {GRAD_ATOL_OF_MAX}*max|g|; loss to rtol 1e-6; launches {expect}): {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"gradients {label}: kernels and plain versions disagree or launches are off: {row}")
    return row


def phase_fwd_bwd(label: str, scene, camera, settings, expect: dict, forward_s: float, frames: int = 3) -> dict:
    """Forward+backward of the bench loss at a path's shapes: the launches of
    each kernel in one fwd+bwd frame (the counts set to 0 just before it) and
    the peak device memory of that frame, finite gradients, then the median
    time over ``frames`` frames with varied seeds, each synchronised on one
    scalar of the gradients; rays/s = W*H*spp*bounces / median, and the
    ratio to the forward frame's time of this run. The leaves are made once
    and not stepped, so the pack cache holds across the frames."""
    device = scene.v0.device
    leaf, leaves = _leaf_scene(scene)
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    _reset_launches()
    loss, grads = bench_loss_grads(leaf, leaves, camera, settings, seed=999)
    _sync(device)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    nonzero = [int((g != 0).sum()) for g in grads]
    del loss, grads
    times = []
    for i in range(frames):
        _sync(device)
        t0 = time.perf_counter()
        _, (g_v0, g_albedo) = bench_loss_grads(leaf, leaves, camera, settings, seed=1000 + i)
        float(g_v0.reshape(-1)[0] + g_albedo.reshape(-1)[0])
        times.append(time.perf_counter() - t0)
    fwd_bwd_s = statistics.median(times)
    rays = settings.width * settings.height * settings.spp * settings.bounces
    out = {"launches": launches, "fwd_bwd_s": fwd_bwd_s, "fwd_bwd_s_all": times,
           "fwd_bwd_rays_per_s": rays / fwd_bwd_s, "forward_frame_s": forward_s,
           "fwd_bwd_over_forward": fwd_bwd_s / forward_s, "peak_allocated_bytes": peak,
           "allocated_before_bytes": base, "grads_finite": finite, "grads_nonzero_v0_albedo": nonzero}
    print(f"fwd+bwd, {label} path, {settings.width}x{settings.height} spp {settings.spp} bounces {settings.bounces}, "
          f"loss mean(image) in (v0, albedo), rays = W*H*spp*bounces: {json.dumps(out)}", flush=True)
    if launches != expect or not finite or nonzero[1] == 0:
        raise AssertionError(f"fwd+bwd {label}: launches {launches} (expected {expect}), finite {finite}, "
                             f"nonzero {nonzero}")
    return out


def phase_trainer(device, steps: int = 100) -> dict:
    """The config 5 trainer (grad/inverse.py) at its defaults on the card:
    the loss must fall; K1 launches as expected (one pack, so the shadow
    rays threshold K1 on every bounce: 2 x bounces per sample, for the
    target frame and every step)."""
    settings = _demo_setup(device=device)[0]
    _reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    result = run_inverse_demo(steps=steps, device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    expect = expect_launches(closest_hit=(steps + 1) * settings.spp * 2 * settings.bounces)
    losses = [loss for _, loss in result["loss_history"]]
    row = {"steps": steps, "wall_s": wall, "s_per_step": wall / steps, "launches": launches,
           "loss_history": result["loss_history"], "albedo_recovered": result["albedo_recovered"],
           "albedo_max_err": result["albedo_max_err"], "vertex_offset_mae": result["vertex_offset_mae"]}
    print(f"trainer, config 5 inverse rendering, {settings.width}x{settings.height} spp {settings.spp} "
          f"bounces {settings.bounces} nee, Adam lr 2e-2, s_per_step = wall / steps with the target frame "
          f"(bar: final loss < first loss; launches {expect}): {json.dumps(row)}", flush=True)
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)) or launches != expect:
        raise AssertionError(f"trainer: loss {losses[0]} -> {losses[-1]}, launches {launches}")
    return row


def phase_pack_refresh(device) -> None:
    """An in-place edit of v0, then a render, equals a render on a fresh
    pack (the cache checks the tensors' versions) and differs from the
    render before the edit."""
    scene, camera, settings = load_scene_file(CONFIG5_SCENE, device=device)
    camera = dataclasses.replace(camera, width=64, height=64)
    settings = dataclasses.replace(settings, width=64, height=64, spp=1)
    before = render_frame(scene, camera, settings)
    with torch.no_grad():
        scene.v0.add_(0.3)
    after = render_frame(scene, camera, settings)
    packed_intersect._PACK_CACHE.clear()
    fresh = render_frame(scene, camera, settings)
    row = {"after_equals_fresh": bool(torch.equal(after, fresh)),
           "mean_abs_change": (after - before).abs().mean().item()}
    print(f"pack refresh after v0.add_(0.3), config 5 64x64 spp 1 (bar: after_equals_fresh, "
          f"mean_abs_change > 0): {json.dumps(row)}", flush=True)
    if not row["after_equals_fresh"] or not row["mean_abs_change"] > 0:
        raise AssertionError(f"stale pack after an in-place edit: {row}")


def phase_cli_progressive(device, frame_s: float) -> dict:
    """The CLI's progressive render of the config 3 stand-in (800x800, spp 4,
    4 bounces, chunks of 1 sample, a film checkpoint, the metrics stream, a
    PPM), in process on the card: exactly 16 K1 launches and 4 chunk events,
    and the PPM equals to_u8 of render_frame. Then render_progressive
    against render_frame (atol 1e-6), a resume from a film saved after 2
    samples (bit-identical to the uninterrupted progressive image), and the
    wall time of the progressive render against the one-shot frame."""
    with tempfile.TemporaryDirectory() as tmp:
        out, film, metrics = (os.path.join(tmp, n) for n in ("x.ppm", "film.npz", "metrics.jsonl"))
        _reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        rc = cli.main(["render", SCENE, "--spp", "4", "--chunk-spp", "1", "--checkpoint", film,
                       "--metrics", metrics, "--out", out])
        cli_s = time.perf_counter() - t0
        launches = _launch_counts()
        chunks = [e for e in read_events(metrics) if e.get("event") == "chunk"]
        scene, camera, settings = load_scene_file(SCENE, device=device)
        settings = dataclasses.replace(settings, spp=4)
        frame = render_frame(scene, camera, settings)
        ppm_equal = bool(np.array_equal(read_ppm(out), to_u8(frame)))
        _sync(device)
        t0 = time.perf_counter()
        prog = render_progressive(scene, camera, settings, chunk_spp=1)
        prog_s = time.perf_counter() - t0
        resume = os.path.join(tmp, "resume.npz")
        ckpt.save_film(resume, render_samples(scene, camera, settings, 0, 2), 2, settings)
        resumed = render_progressive(scene, camera, settings, chunk_spp=1, checkpoint_path=resume)
    expect = expect_launches(closest_hit=16)
    row = {"rc": rc, "launches": launches, "chunk_events": len(chunks), "ppm_equals_frame": ppm_equal,
           "progressive_max_abs_err": (prog - frame.cpu()).abs().max().item(),
           "resume_bit_identical": bool(torch.equal(resumed, prog)), "cli_wall_s": cli_s,
           "progressive_s": prog_s, "frame_s": frame_s, "progressive_over_frame": prog_s / frame_s,
           "chunk_seconds": [e["seconds"] for e in chunks]}
    print(f"CLI progressive render, config3 800x800 spp 4 bounces 4, chunks of 1 (bar: rc 0, launches {expect}, "
          f"4 chunk events, PPM = to_u8(render_frame), |progressive - frame| <= 1e-6, resume bit-identical; "
          f"cli_wall_s includes loading, packing and writing the PPM): {json.dumps(row)}", flush=True)
    if not (rc == 0 and launches == expect and len(chunks) == 4 and ppm_equal and row["resume_bit_identical"]
            and row["progressive_max_abs_err"] <= 1e-6):
        raise AssertionError(f"CLI progressive render: {row}")
    return row


def glass_mirror_scene(device, mirror_floor: bool = True):
    """The config 3 stand-in with its body made glass (ior 1.5, two-sided,
    so rays leave it) and its floor a mirror (or, with ``mirror_floor``
    False, still diffuse), built in code."""
    cfg = load_config(SCENE)
    cfg["materials"][0] = {"name": "body", "type": "glass", "refractive_index": 1.5,
                           "transmittance_color": [0.95, 0.97, 1.0]}
    if mirror_floor:
        cfg["materials"][1] = {"name": "floor", "type": "mirror", "specular_color": [0.9, 0.9, 0.9]}
    specs, materials, camera, settings, _ = parse_config(cfg, os.path.dirname(SCENE))
    specs = [dataclasses.replace(sp, two_sided=True) if sp.mat_id == 0 else sp for sp in specs]
    scene = build_scene(specs, materials, pad_to_multiple=settings.tri_block, device=device)
    return scene, camera.to(device), dataclasses.replace(settings, spp=4)


def phase_glass_mirror(device, naive_frame_s: float) -> dict:
    """Mirror and glass: 128x128 spp 2 through the kernels against the plain
    versions (naive and naive with rr_start 2; NEE and MIS with the floor
    left diffuse, since a scene with no diffuse vertex samples no light),
    then the naive frame at 800x800, spp 4, 4 bounces (exactly 16 K1
    launches) and its time against the diffuse config 3 frame's."""
    scene, camera, settings = glass_mirror_scene(device)
    for change in ({}, {"rr_start": 2}):
        label = "glass and mirror, " + ("rr_start 2, " if "rr_start" in change else "")
        phase_image_check(scene, camera, dataclasses.replace(settings, **change), size=128, spp=2, label=label)
    glass_scene = glass_mirror_scene(device, mirror_floor=False)[0]
    for estimator in ("nee", "mis"):
        phase_image_check(glass_scene, camera, dataclasses.replace(settings, estimator=estimator), size=128, spp=2,
                          label="glass body, diffuse floor, ")
    out = phase_full_frame("glass and mirror naive", scene, camera, settings, expect_launches(closest_hit=16))
    print(f"glass and mirror frame over the diffuse config3 frame: {out['frame_s'] / naive_frame_s:.4f}", flush=True)
    return out


def phase_mask_hit_check(name: str, label: str, scene, camera, settings, packed, packed2, compacted: dict) -> dict:
    """K1 or K3 on the uncompacted bounce-1 rays, with the live mask as
    ``alive`` (what mask mode hands the search), against the plain version,
    exactly; its time beside the same rays compacted (``compacted``)."""
    _, state, _ = sample0_bounce0(scene, camera, settings, packed)
    if name == "closest_hit":
        args = prepare_rays(state.o, state.d, packed2, alive=state.alive) + (packed2.w, DEFAULT_RAY_TILE)
        row = hit_check(name, label, closest_hit, closest_hit_reference, args, packed2, exact=True)
    else:
        args = prepare_rays_streamed(state.o, state.d, packed2, alive=state.alive) + (STREAM_RAY_TILE,)
        row = hit_check(name, label, closest_hit_streamed, closest_hit_streamed_reference, args, packed2, exact=True)
    row["dead_share"] = 1.0 - state.alive.double().mean().item()
    print(f"{name} {label}: dead lanes {row['dead_share']:.4f}, {row['ms']:.4f} ms uncompacted vs "
          f"{compacted['ms']:.4f} ms compacted", flush=True)
    return row


def phase_compact_modes(label: str, scene, camera, settings, expect: dict) -> dict:
    """The frame in compact_mode permute, mask and hybrid: launches, median
    frame time over 3 and one profiled frame each (phase_full_frame), and the
    mask and hybrid images against permute's (the image bar; the count of
    differing pixels is printed)."""
    rows = {}
    want = render_frame(scene, camera, settings)
    for mode in ("permute", "mask", "hybrid"):
        st = dataclasses.replace(settings, compact_mode=mode)
        rows[mode] = phase_full_frame(f"{label} {mode}", scene, camera, st, expect, profiled=True)
        if mode != "permute":
            rows[mode]["vs_permute"] = image_diff(render_frame(scene, camera, st), want)
    summary = {mode: {"frame_s": r["frame_s"], "over_permute": r["frame_s"] / rows["permute"]["frame_s"],
                      "device_busy_ms": r["profile"]["device_busy_ms"], **r.get("vs_permute", {})}
               for mode, r in rows.items()}
    print(f"compact modes, {label} (bar: mask and hybrid meet the image bar against permute): "
          f"{json.dumps(summary)}", flush=True)
    if not all(meets_image_bar(r["vs_permute"]) for m, r in rows.items() if m != "permute"):
        raise AssertionError(f"compact modes {label}: a mode misses the image bar against permute: {summary}")
    return rows


def phase_normal_aov(scene, camera, settings) -> dict:
    """The normal AOVs at full size: exactly one K1 launch each, the image
    equal to the plain version's, the median time over 3."""
    out = {}
    for aov in ("normal", "normal_unit"):
        st = dataclasses.replace(settings, aov=aov)
        _reset_launches()
        img = render_frame(scene, camera, st)
        _sync(scene.v0.device)
        launches = _launch_counts()
        equal = bool(torch.equal(img, render_frame(scene, camera, dataclasses.replace(st, intersector="plucker"))))
        frame_ms = median_ms(lambda: float(render_frame(scene, camera, st).sum()), scene.v0.device, 3)
        out[aov] = {"launches": launches, "equals_plain": equal, "hit_share": (img.abs().sum(-1) > 0).double()
                    .mean().item(), "ms": frame_ms}
    expect = expect_launches(closest_hit=1)
    print(f"normal AOVs, config3 {settings.width}x{settings.height} (bar: launches {expect}, equals_plain): "
          f"{json.dumps(out)}", flush=True)
    if not all(r["launches"] == expect and r["equals_plain"] for r in out.values()):
        raise AssertionError(f"normal AOVs: {out}")
    return out


def phase_live_and_view(device) -> dict:
    """live_view on the config 3 stand-in at 800x800 (chunks of 2 samples up
    to 4, a 'w' command after the first chunk): accumulation restarts, so
    3 chunks render (24 K1 launches) and 4 samples remain, the camera moved
    by 0.2, live.png and status.json written. Then the CLI's turntable
    (2 frames, spp 1) and the config 5 trainer through the CLI (3 steps)."""
    scene, camera, settings = load_scene_file(SCENE, device=device)
    feed = iter([[], ["w"]])
    with tempfile.TemporaryDirectory() as tmp:
        _reset_launches()
        t0 = time.perf_counter()
        cam, spp = live_view(scene, camera, settings, tmp, chunk_spp=2, max_spp=4, command_source=lambda: next(feed, []))
        live_s = time.perf_counter() - t0
        live = {"launches": _launch_counts(), "spp": spp, "wall_s": live_s,
                "moved_z": camera.position[2].item() - cam.position[2].item(),
                "status": json.load(open(os.path.join(tmp, "status.json"))),
                "live_png_bytes": os.path.getsize(os.path.join(tmp, "live.png"))}
        _reset_launches()
        view_rc = cli.main(["view", SCENE, "--frames", "2", "--spp", "1", "--out", os.path.join(tmp, "turn")])
        view = {"rc": view_rc, "launches": _launch_counts(), "frames": sorted(os.listdir(os.path.join(tmp, "turn")))}
        _reset_launches()
        invert_rc = cli.main(["invert", "--steps", "3"])
        invert = {"rc": invert_rc, "launches": _launch_counts()}
    expect_live = expect_launches(closest_hit=3 * 2 * settings.bounces)
    expect_view = expect_launches(closest_hit=2 * settings.bounces)
    spp5, bounces5 = 8, 2  # the trainer's defaults: (steps + 1) frames of spp x 2 x bounces K1 launches
    expect_invert = expect_launches(closest_hit=4 * spp5 * 2 * bounces5)
    row = {"live": live, "view": view, "invert": invert}
    print(f"live view and CLI view/invert, config3 800x800 (bar: live {expect_live}, spp 4, moved 0.2, status spp 4; "
          f"view rc 0, {expect_view}; invert rc 0, {expect_invert}): {json.dumps(row)}", flush=True)
    ok = (live["launches"] == expect_live and spp == 4 and abs(live["moved_z"] - 0.2) < 1e-5
          and live["status"]["spp"] == 4 and view_rc == 0 and view["launches"] == expect_view
          and len(view["frames"]) == 2 and invert_rc == 0 and invert["launches"] == expect_invert)
    if not ok:
        raise AssertionError(f"live view / CLI view / invert: {row}")
    return row


def body_scale_scene(path: str, device):
    """``(scene_fn(scale), camera, settings)`` of a stand-in config whose
    body (the icosphere: the one-sided geometry, the planes are two-sided)
    has its vertices scaled by the tensor ``scale``; the scene is built on
    ``device`` as load_scene_file builds it."""
    specs, materials, camera, settings, textures = parse_config(load_config(path), os.path.dirname(path))
    body = {i: sp.vertices.to(device) for i, sp in enumerate(specs) if not sp.two_sided}

    def scene_fn(scale):
        scaled = [dataclasses.replace(sp, vertices=body[i] * scale) if i in body else sp for i, sp in enumerate(specs)]
        return build_scene(scaled, materials, pad_to_multiple=settings.tri_block, textures=textures, device=device)

    return scene_fn, camera.to(device), settings


def edge_call_launches(settings, trace_spp: int, shadow: bool, receivers: int = 1) -> dict:
    """K1/K2 launches of one value_and_grad_with_edges call on a resident
    pack: the interior frame (as the full-frame phases count it), the
    primary term's f_in/f_out traces (trace_spp samples each, one pack, so
    every bounce's shadow rays threshold K1) and, with ``shadow``, per
    receiver set one search of the walk (no mirror or glass in the stand-ins)
    and two of f_sa."""
    nee = settings.estimator != "naive"
    if nee:
        k1, k2 = settings.spp * (settings.bounces + 1), settings.spp * (settings.bounces - 1)
    else:
        k1, k2 = settings.spp * settings.bounces, 0
    k1 += 2 * trace_spp * settings.bounces * (2 if nee else 1)
    if shadow:
        k1 += 3 * receivers
    return expect_launches(closest_hit=k1, occluded=k2)


def _timed(fn, device, reps: int = 3):
    """Median and all wall times of ``fn(i)`` for i in range(reps),
    synchronised before and after each."""
    times = []
    for i in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn(i)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def phase_edge_gradient(label: str, path: str, device, shadow: bool = False, n_samples: int = 1024,
                        trace_spp: int = 4, shadow_samples: int = 512, spp: int = 4) -> dict:
    """value_and_grad_with_edges at a stand-in's full size: the parameter
    scales the body's vertices, the target is the render at scale 0.95 and
    the loss the mean squared difference. One call with the counts set to 0
    (launches as edge_call_launches says, peak device memory), then the
    median of 3 calls with varied keys, one more call split by its spans
    (span_times: the interior fwd+bwd, the primary term, and the shadow
    term with ``shadow``), the packing that every call repeats (scene_fn
    builds fresh tensors), the edge count, the boundary term's share of the
    gradient (the call's less the detached one); then the same key through
    the plain versions: the hits are the same, so the gradients agree
    within rtol 1e-4, the bar of the other kernel-vs-plain gradient checks."""
    from gpupathtracer_tpu_torch.grad import edges
    from gpupathtracer_tpu_torch.ops import threefry

    scene_fn, camera, settings = body_scale_scene(path, device)
    settings = dataclasses.replace(settings, spp=spp)
    one = torch.tensor(1.0, device=device)
    with torch.no_grad():
        target = render_frame(scene_fn(torch.tensor(0.95, device=device)), camera, settings)

    def image_loss(img):
        return ((img - target) ** 2).mean()

    t0 = time.perf_counter()
    table = edges.build_edge_table(scene_fn(one))
    table_s = time.perf_counter() - t0
    kw = dict(n_samples=n_samples, trace_spp=trace_spp, shadow_edges=shadow, shadow_samples=shadow_samples)
    key = lambda i: threefry.PRNGKey(i, device=device)
    call = lambda st, i: edges.value_and_grad_with_edges(image_loss, scene_fn, one, camera, st, table, key(i), **kw)
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    loss, g = call(settings, 0)
    _sync(device)
    launches, peak = _launch_counts(), torch.cuda.max_memory_allocated(device)
    expect = edge_call_launches(settings, trace_spp, shadow)
    total_s, total_all = _timed(lambda i: float(call(settings, 100 + i)[1]), device)
    spans = span_times(lambda: call(settings, 200), ("edges.interior", "edges.primary", "edges.shadow"))
    leaf = one.detach().requires_grad_()
    detached = image_loss(render_frame(scene_fn(leaf), camera, settings))  # the interior term alone
    g_interior = torch.autograd.grad(detached, leaf)[0] if detached.requires_grad else torch.zeros_like(one)
    pack_times = []
    for _ in range(3):  # a fresh scene each time: the cache misses, as in every call
        fresh = scene_fn(one)
        _sync(device)
        t0 = time.perf_counter()
        pack_scene(fresh, tri_block=settings.tri_block)
        _sync(device)
        pack_times.append(time.perf_counter() - t0)
    plain_loss, g_plain = call(dataclasses.replace(settings, intersector="plucker"), 0)
    g_b = (g - g_interior).item()
    row = {
        "size": [settings.width, settings.height], "spp": settings.spp, "bounces": settings.bounces,
        "estimator": settings.estimator, "edges": table.num_edges, "build_edge_table_s": table_s,
        "n_samples": n_samples, "trace_spp": trace_spp, "shadow_samples": shadow_samples if shadow else 0,
        "launches": launches, "expected_launches": expect, "peak_allocated_bytes": peak,
        "call_s": total_s, "call_s_all": total_all, "profiled_call": spans,
        "pack_tri_block_s": statistics.median(pack_times),
        "packs_per_call": 2 + (1 if settings.tri_block_secondary else 0) + (1 if shadow else 0),
        "loss": loss.item(), "grad": g.item(), "grad_interior": g_interior.item(), "grad_boundary": g_b,
        "boundary_share": abs(g_b) / max(abs(g_b) + abs(g_interior.item()), 1e-30),
        "grad_plain": g_plain.item(), "loss_plain": plain_loss.item(),
    }
    bar = (f"launches {expect}; finite; |g - g_plain| <= {GRAD_RTOL}|g_plain|; loss to rtol 1e-6; each span "
           "launched device work")
    print(f"edge gradient, {label} (bar: {bar}): {json.dumps(row)}", flush=True)
    ok = (launches == expect and bool(torch.isfinite(g)) and abs(g.item() - g_plain.item()) <= GRAD_RTOL * abs(g_plain.item())
          and abs(loss.item() - plain_loss.item()) <= 1e-6 * abs(plain_loss.item()) and g_b != 0.0
          and spans["edges.interior"]["device_ops"] > 0 and spans["edges.primary"]["device_ops"] > 0
          and (spans["edges.shadow"]["device_ops"] > 0) == shadow)
    if not ok:
        raise AssertionError(f"edge gradient {label}: {row}")
    return row


def phase_edge_hierarchy(device, n_samples: int = 512) -> dict:
    """The config 6 stand-in's edges: build_edge_table and
    build_edge_clusters seconds, then one shadow_edge_gradient call with the
    clusters on the streamed packs (K3 carries its closest hits): seconds,
    launches, peak memory; the same call profiled, where the hierarchical
    picker's span must run once; and the same key and clusters through the
    plain versions (rtol 1e-4)."""
    from gpupathtracer_tpu_torch.grad import edges
    from gpupathtracer_tpu_torch.ops import threefry

    scene_fn, camera, settings = body_scale_scene(STREAM_SCENE, device)
    one = torch.tensor(1.0, device=device)
    scene = scene_fn(one)
    t0 = time.perf_counter()
    table = edges.build_edge_table(scene)
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clusters = edges.build_edge_clusters(scene, table)
    clusters_s = time.perf_counter() - t0
    del scene
    cot = torch.full((settings.height, settings.width, 3), 1.0 / (settings.height * settings.width * 3), device=device)
    key = threefry.PRNGKey(13, device=device)
    call = lambda st: edges.shadow_edge_gradient(scene_fn, one, camera, st, cot, table, key, n_samples=n_samples,
                                                 clusters=clusters)
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    t0 = time.perf_counter()
    g = call(settings)
    float(g)
    call_s = time.perf_counter() - t0
    launches, peak = _launch_counts(), torch.cuda.max_memory_allocated(device)
    spans = span_times(lambda: call(settings), ("edges.pick_hierarchical",))
    g_plain = call(dataclasses.replace(settings, intersector="plucker"))
    expect = expect_launches(closest_hit_streamed=3)
    row = {"edges": table.num_edges, "threshold": edges._HIER_EDGE_THRESHOLD, "build_edge_table_s": table_s,
           "build_edge_clusters_s": clusters_s, "clusters": clusters.num_clusters, "cluster_size": clusters.size,
           "shadow_samples": n_samples, "call_s": call_s, "launches": launches, "peak_allocated_bytes": peak,
           "profiled_call": spans, "grad": g.item(), "grad_plain": g_plain.item()}
    print(f"edge hierarchy, config6 stand-in (bar: launches {expect}; the hierarchical picker ran once; finite; "
          f"|g - g_plain| <= {GRAD_RTOL}|g_plain|): {json.dumps(row)}", flush=True)
    if (spans["edges.pick_hierarchical"]["count"] != 1 or launches != expect or not bool(torch.isfinite(g))
            or abs(g.item() - g_plain.item()) > GRAD_RTOL * abs(g_plain.item())):
        raise AssertionError(f"edge hierarchy config6: {row}")
    return row


def demo_first_step_check(device) -> dict:
    """Each edge demo's first step (its problem at the defaults, its first
    key) through the kernels and through the plain versions: the loss to
    rtol 1e-6 and each gradient leaf to rtol 1e-4."""
    from gpupathtracer_tpu_torch.ops import threefry

    out = {}
    for name, problem, seed, n_samples in (("silhouette", silhouette_problem, 3, 1024),
                                           ("camera", camera_problem, 9, 2048)):
        pr = problem(device=device)
        _, k = threefry.split(threefry.PRNGKey(seed, device=device))
        loss, g = pr.value_and_grad(k, n_samples)
        plain_loss, g_plain = pr.value_and_grad(k, n_samples, dataclasses.replace(pr.settings, intersector="plucker"))
        g, g_plain = ({"scale": g}, {"scale": g_plain}) if name == "silhouette" else (g, g_plain)
        row = {"loss": loss.item(), "loss_plain": plain_loss.item(), "grad": {k_: v.item() for k_, v in g.items()},
               "grad_plain": {k_: v.item() for k_, v in g_plain.items()}}
        out[name] = row
        ok = abs(row["loss"] - row["loss_plain"]) <= 1e-6 * abs(row["loss_plain"]) and all(
            math.isfinite(row["grad"][k_]) and abs(row["grad"][k_] - v) <= GRAD_RTOL * abs(v)
            for k_, v in row["grad_plain"].items()
        )
        if not ok:
            raise AssertionError(f"{name} demo, first step against the plain versions: {row}")
    print(f"edge demos' first step (bar: loss to rtol 1e-6, |g - g_plain| <= {GRAD_RTOL}|g_plain| per leaf): "
          f"{json.dumps(out)}", flush=True)
    return out


def phase_edge_demos(device) -> dict:
    """The silhouette (40 steps) and camera (60 steps) demos at their
    defaults (64x64, spp 16, blocks of 8 through K1), after their first
    step against the plain versions (demo_first_step_check): the recovered
    errors, the detached gradient at the start (exactly 0), seconds per
    step with the target frame, K1 launches; then the CLI's invert --mode
    silhouette and camera for 4 steps at spp 4."""
    from gpupathtracer_tpu_torch.grad.inverse import run_camera_demo, run_silhouette_demo

    out = {"first step": demo_first_step_check(device)}
    for name, demo, steps in (("silhouette", run_silhouette_demo, 40), ("camera", run_camera_demo, 60)):
        _reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        result = demo(device=device)
        _sync(device)
        wall = time.perf_counter() - t0
        g0 = result["detached_gradient_at_init"]
        g0 = [g0] if name == "silhouette" else list(g0.values())
        losses = [h[1] for h in result["history"]]
        out[name] = {"steps": steps, "wall_s": wall, "s_per_step": wall / steps, "launches": _launch_counts(),
                     "losses": losses, **{k: v for k, v in result.items() if k != "history"}}
        if any(v != 0.0 for v in g0) or not losses[-1] < losses[0] or out[name]["launches"]["closest_hit"] == 0:
            raise AssertionError(f"{name} demo: {out[name]}")
    for mode in ("silhouette", "camera"):
        _reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["invert", "--mode", mode, "--steps", "4", "--spp", "4"])
        out[f"cli {mode}"] = {"rc": rc, "wall_s": time.perf_counter() - t0, "launches": _launch_counts()}
        if rc != 0 or out[f"cli {mode}"]["launches"]["closest_hit"] == 0:
            raise AssertionError(f"cli invert --mode {mode}: {out[f'cli {mode}']}")
    print(f"edge demos (bar: detached_gradient_at_init = 0, final loss < first, K1 launches > 0; CLI rc 0): "
          f"{json.dumps(out)}", flush=True)
    return out


def phase_threefry_frame(scene, camera, settings) -> dict:
    """The naive frame with rng="threefry" at full size through the kernels
    against the plain versions (the image bar), and its median frame time
    over 3 seeds beside the PCG frame's, measured in turns (PCG, threefry)."""
    st = dataclasses.replace(settings, rng="threefry")
    _reset_launches()
    img = render_frame(scene, camera, st)
    _sync(scene.v0.device)
    launches = _launch_counts()
    row = image_diff(img, render_frame(scene, camera, dataclasses.replace(st, intersector="plucker")))
    times = {"pcg": [], "threefry": []}
    for i in range(3):
        for name, s in (("pcg", settings), ("threefry", st)):
            _sync(scene.v0.device)
            t0 = time.perf_counter()
            float(render_frame(scene, camera, s, seed=1000 + i).sum())
            _sync(scene.v0.device)
            times[name].append(time.perf_counter() - t0)
    frame_s, pcg_s = statistics.median(times["threefry"]), statistics.median(times["pcg"])
    row.update(launches=launches, frame_s=frame_s, frame_s_all=times["threefry"], pcg_frame_s=pcg_s,
               pcg_frame_s_all=times["pcg"], threefry_over_pcg=frame_s / pcg_s, image_mean=img.mean().item())
    expect = expect_launches(closest_hit=settings.spp * settings.bounces)
    print(f"threefry frame, config3 naive {settings.width}x{settings.height} spp {settings.spp} "
          f"(bar: the image bar against the plain versions; launches {expect}): {json.dumps(row)}", flush=True)
    if not meets_image_bar(row) or launches != expect:
        raise AssertionError(f"threefry frame: {row}")
    return row


def kernel_summary(name: str, rows, launches: int, launches_by_path: dict) -> dict:
    """The summary entry of one kernel over its checks at main-path shapes."""
    b = bound(sum(r["flop"] for r in rows), sum(r["bytes"] for r in rows))
    return {
        "name": name, "route": "cuda", "source": KERNELS[name]["source"], "replaces": KERNELS[name]["replaces"],
        "launches": launches, "launches_by_path": launches_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": b["bound_by"], "library_ms": None,
    }


def main() -> None:
    t_start = time.perf_counter()
    phase_device()
    device = torch.device("cuda")
    # The parity bars need f32 products, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    # The naive path (config 3 stand-in).
    scene, camera, settings = load_scene_file(SCENE, device=device)
    settings = dataclasses.replace(settings, spp=4)  # the bench's spp
    packed = pack_scene(scene, tri_block=settings.tri_block)
    packed2 = pack_scene(scene, tri_block=settings.tri_block_secondary)
    for p in (packed, packed2):
        phase_live_zeros(f"config3 tb {p.tri_block}", p)
    (o, d), (o2, d2) = main_path_rays(scene, camera, settings, packed)
    k1_rows = [
        phase_kernel_check("camera rays", o, d, packed),
        phase_kernel_check("bounce-1 rays", o2, d2, packed2),
    ]
    phase_image_check(scene, camera, settings, size=256, spp=2)
    naive_expect = expect_launches(closest_hit=settings.spp * settings.bounces)
    naive = phase_full_frame("naive", scene, camera, settings, naive_expect, profiled=True)
    naive_bwd = phase_fwd_bwd("config3 naive", scene, camera, settings, naive_expect, naive["frame_s"])
    # The entry point, the render options and the compaction modes on the naive path.
    cli_row = phase_cli_progressive(device, naive["frame_s"])
    k1_mask_row = phase_mask_hit_check("closest_hit", "bounce-1 rays uncompacted, live mask as alive (mask mode)",
                                       scene, camera, settings, packed, packed2, k1_rows[1])
    naive_modes = phase_compact_modes("config3 naive", scene, camera, settings, naive_expect)
    normal = phase_normal_aov(scene, camera, settings)
    glass = phase_glass_mirror(device, naive["frame_s"])
    live = phase_live_and_view(device)

    # The NEE path (config 8 stand-in).
    scene, camera, settings = load_scene_file(NEE_SCENE, device=device)
    settings = dataclasses.replace(settings, spp=4)
    packed = pack_scene(scene, tri_block=settings.tri_block)
    packed2 = pack_scene(scene, tri_block=settings.tri_block_secondary)
    for p in (packed, packed2):
        phase_live_zeros(f"config8 tb {p.tri_block}", p)
    k2_row = occlusion_check(
        "occluded", "bounce-1 shadow rays", occluded, occluded_reference,
        nee_shadow_inputs(scene, camera, settings, packed, packed2, "occluded_reference"), exact=True,
    )
    for estimator in ("nee", "mis"):
        phase_image_check(scene, camera, dataclasses.replace(settings, estimator=estimator), size=128, spp=2)
    nee_expect = lambda st: expect_launches(
        closest_hit=st.spp * (st.bounces + 1), occluded=st.spp * (st.bounces - 1)
    )
    nee = phase_full_frame("nee", scene, camera, settings, nee_expect(settings), profiled=True)
    small = dataclasses.replace(settings, width=128, height=128, spp=2)
    grad_nee = phase_grad_check("config8", scene, dataclasses.replace(camera, width=128, height=128), small,
                                nee_expect(small))
    nee_bwd = phase_fwd_bwd("config8 nee", scene, camera, settings, nee_expect(settings), nee["frame_s"])
    k2_mask_row = occlusion_check(
        "occluded", "bounce-1 shadow rays uncompacted, max_t = 0 on dead lanes (mask mode)", occluded,
        occluded_reference,
        nee_shadow_inputs(scene, camera, settings, packed, packed2, "occluded_reference", mask_mode=True), exact=True,
    )
    nee_modes = phase_compact_modes("config8 nee", scene, camera, settings, nee_expect(settings))
    del scene, packed, packed2

    # The streamed path (config 6 stand-in): both packs past the budget.
    scene, camera, settings = load_scene_file(STREAM_SCENE, device=device)
    settings = dataclasses.replace(settings, spp=2)  # the bench's spp for config 6
    packed = pack_scene(scene, tri_block=settings.tri_block)
    packed2 = pack_scene(scene, tri_block=settings.tri_block_secondary)
    for p in (packed, packed2):
        phase_live_zeros(f"config6 tb {p.tri_block}", p)
    (o, d), (o2, d2) = main_path_rays(scene, camera, settings, packed)
    k3_rows = [
        phase_streamed_check("camera rays", o, d, packed),
        phase_streamed_check("bounce-1 rays", o2, d2, packed2),
    ]
    split = [
        phase_split("camera rays", o, d, packed, k3_rows[0]),
        phase_split("bounce-1 rays", o2, d2, packed2, k3_rows[1]),
    ]
    del o, d, o2, d2
    k3_mask_row = phase_mask_hit_check(
        "closest_hit_streamed", "bounce-1 rays uncompacted, live mask as alive (mask mode)",
        scene, camera, settings, packed, packed2, k3_rows[1],
    )
    nee_settings = dataclasses.replace(settings, estimator="nee")
    k4_row = occlusion_check(
        "occluded_streamed", "bounce-1 shadow rays", occluded_streamed, occluded_streamed_reference,
        nee_shadow_inputs(scene, camera, nee_settings, packed, packed2, "occluded_streamed_reference"),
    )
    k4_mask_row = occlusion_check(
        "occluded_streamed", "bounce-1 shadow rays uncompacted, max_t = 0 on dead lanes (mask mode)",
        occluded_streamed, occluded_streamed_reference,
        nee_shadow_inputs(scene, camera, nee_settings, packed, packed2, "occluded_streamed_reference", mask_mode=True),
        exact=True,
    )
    for st in (settings, nee_settings):
        phase_image_check(scene, camera, st, size=128, spp=2)
    streamed = phase_full_frame(
        "streamed naive", scene, camera, settings,
        expect_launches(closest_hit_streamed=settings.spp * settings.bounces), profiled=True,
    )
    streamed_bwd = phase_fwd_bwd(
        "config6 streamed naive", scene, camera, settings,
        expect_launches(closest_hit_streamed=settings.spp * settings.bounces), streamed["frame_s"],
    )
    nee_settings = dataclasses.replace(nee_settings, spp=1, bounces=3)
    streamed_nee_expect = expect_launches(
        closest_hit_streamed=nee_settings.spp * (nee_settings.bounces + 1),
        occluded_streamed=nee_settings.spp * (nee_settings.bounces - 1),
    )
    streamed_nee = phase_full_frame("streamed nee", scene, camera, nee_settings, streamed_nee_expect)
    streamed_nee_bwd = phase_fwd_bwd(
        "config6 streamed nee", scene, camera, nee_settings, streamed_nee_expect, streamed_nee["frame_s"]
    )
    # Streamed packs sort their rays, which turns mask mode into permute;
    # with the sort off, mask mode hands K3 its dead lanes in place.
    streamed_expect = expect_launches(closest_hit_streamed=settings.spp * settings.bounces)
    streamed_modes = phase_compact_modes("config6 streamed naive", scene, camera, settings, streamed_expect)
    streamed_modes_unsorted = phase_compact_modes(
        "config6 streamed naive, sort_rays off", scene, camera, dataclasses.replace(settings, sort_rays=False),
        streamed_expect,
    )
    del scene, packed, packed2
    phase_light_cdf(device)
    print(json.dumps({"split": split}), flush=True)

    # The differentiable path on config 5: gradients through K1 against the
    # plain versions at the trainer's shapes, the trainer, the pack refresh.
    settings, camera, make_scene, mesh = _demo_setup(device=device)
    scene = make_scene(torch.tensor([0.5, 0.5, 0.5], device=device),
                       torch.zeros(mesh.vertices.shape, device=device))
    grad_config5 = phase_grad_check(
        "config5", scene, camera, settings, expect_launches(closest_hit=settings.spp * 2 * settings.bounces)
    )
    trainer = phase_trainer(device)
    phase_pack_refresh(device)

    # The boundary term (grad/edges.py) and what it brought: primary
    # silhouettes on config 3, primary and shadow silhouettes on config 8,
    # the edge hierarchy on config 6's streamed packs, the demos and their
    # CLI, and the threefry sampler.
    edge3 = phase_edge_gradient("config3 stand-in, primary term", SCENE, device)
    edge8 = phase_edge_gradient("config8 stand-in, primary and shadow terms", NEE_SCENE, device, shadow=True)
    hier6 = phase_edge_hierarchy(device)
    demos = phase_edge_demos(device)
    scene, camera, settings = load_scene_file(SCENE, device=device)
    threefry_row = phase_threefry_frame(scene, camera, dataclasses.replace(settings, spp=4))
    del scene

    paths = {"naive": naive, "nee": nee, "streamed naive": streamed, "streamed nee": streamed_nee,
             "fwd+bwd naive": naive_bwd, "fwd+bwd nee": nee_bwd, "fwd+bwd streamed naive": streamed_bwd,
             "fwd+bwd streamed nee": streamed_nee_bwd,
             "grad check config8": grad_nee, "grad check config5": grad_config5, "trainer": trainer,
             "cli progressive": cli_row, "glass and mirror naive": glass,
             "normal aov": normal["normal"], "normal_unit aov": normal["normal_unit"],
             "live view": live["live"], "cli view": live["view"], "cli invert": live["invert"],
             "edge gradient config3": edge3, "edge gradient config8": edge8, "edge hierarchy config6": hier6,
             "silhouette demo": demos["silhouette"], "camera demo": demos["camera"],
             "cli invert silhouette": demos["cli silhouette"], "cli invert camera": demos["cli camera"],
             "threefry frame": threefry_row}
    for label, rows in (("naive", naive_modes), ("nee", nee_modes), ("streamed naive", streamed_modes),
                        ("streamed naive unsorted", streamed_modes_unsorted)):
        for mode in ("mask", "hybrid"):
            paths[f"{label} {mode}"] = rows[mode]
    by_path = lambda name: {p: r["launches"][name] for p, r in paths.items()}
    summary = [
        kernel_summary("closest_hit", k1_rows, nee["launches"]["closest_hit"], by_path("closest_hit")),
        kernel_summary("occluded", [k2_row], nee["launches"]["occluded"], by_path("occluded")),
        kernel_summary("closest_hit_streamed", k3_rows, streamed["launches"]["closest_hit_streamed"],
                       by_path("closest_hit_streamed")),
        kernel_summary("occluded_streamed", [k4_row], streamed_nee["launches"]["occluded_streamed"],
                       by_path("occluded_streamed")),
    ]
    mask_rows = {"closest_hit": k1_mask_row, "occluded": k2_mask_row, "closest_hit_streamed": k3_mask_row,
                 "occluded_streamed": k4_mask_row}
    print(json.dumps({"mask_mode_checks": {k: {f: r[f] for f in ("ms", "max_abs_err", "bound_ms")}
                                           for k, r in mask_rows.items()}}), flush=True)
    print(f"total wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    result = {
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
