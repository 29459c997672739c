"""Smoke run of the PyTorch + CUDA port (gpupathtracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
1. device: the card's name and power limit from nvidia-smi;
2. build: nvcc builds the seven kernel sources of csrc/ from this checkout
   (the four searches, the PCG sampler's pcg.cu, the naive shade step's
   shade.cu and the searches' schedule.cu), all started together,
   with ptxas's registers and shared memory per kernel, and each kernel's launch shape at its ray tile (128 rays for K1
   and K2, 64 for K3 and K4) with its resident CTAs and warps per SM, for
   every precision mode's instantiation (and K3's traversal-mode kernel),
   with its HMMA and FFMA instructions, and those of every kernel entry of
   the four libraries (cuobjdump -sass of the built library; a bf16
   instantiation, the tensor-core route, without HMMA fails the run);
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
    (2 frames, with --gif: turntable.gif decodes to 2 frames) and the CLI's
    config 5 trainer (3 steps), with their K1 launches;
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
and the BVH route, the host builders and the distributed renderer
(parallel/), whose scene-sharded searches run the kernels on packs of a
slice of the scene's rows:
36. right after phase 2: the host library (csrc/firefly_native.cpp: OBJ,
    BVH and edge-table builders) built by the host C++ compiler from this
    checkout, timed;
37. beside phases 3 and 9: K1 on phase 3's camera and bounce-1 rays
    against scene shard 1 of 2 of the config 3 stand-in (what a rank of a
    1x2 scene axis searches), exactly equal to its plain version; K3 on
    phase 9's rays against shard 1 of 2 of the config 6 stand-in (a
    streamed shard pack), with the hit bar and the same packed rows;
38. the config 3 stand-in's naive frame with intersector "bvh" (800x800,
    spp 4, 4 bounces): no kernel launch, within the image bar of the K1
    frame, the median of 3 frames of each route in turns, one profiled bvh
    frame at spp 1 (device busy, idle share);
39. the config 6 stand-in's edge table and BVH through the native and the
    Python builders: seconds, arrays equal;
40. the bvh frame of the config 6 stand-in cut to 400x400, spp 1 (a
    diagnostic: the BVH route against K3), as 38;
41. the distributed renderer, two processes on the one card under gloo:
    the config 3 stand-in at full width on meshes 2x1 and 1x2 under each
    scene strategy, the config 6 stand-in (800x800, spp 2) on 1x2
    (allgather; K3 on the shard packs), the config 8 stand-in's NEE on 2x1
    (K1 and K2), each against the single-process frame (exact, else the
    image bar with the count of differing pixels), with the launches of
    each kernel per rank (counts set to 0 just before each frame) and the
    median frame time per rank; and one 2x1 fwd+bwd of the bench loss whose
    gradient is within rtol 1e-4 of the single-process one;
and the last modules: the staged wavefront and the bench:
42. the staged wavefront (parallel/pipeline.py), four processes on the one
    card under gloo, one a stage (4 bounces, 4 microbatches): the config 3
    stand-in at full width (800x800, spp 4; K1), the config 8 stand-in's
    NEE with 4 bounces (512x512, spp 4; K1, K2) and the config 6 stand-in's
    NEE, streamed (800x800, spp 1, 4 bounces; K3, K4), each against the
    single-process render_frame and against its frame through the plain
    versions (0 differing pixels each), with the launches of each kernel per
    stage (the skip rule: M a sample for each search of the stage's bounce),
    the frame seconds and the host seconds inside shift per rank;
43. the bench (gpupathtracer_tpu_torch/bench.py): the CLI's benchmark verb
    without --full on the config 3 stand-in (the headline and the spec-spp
    frame; its last line must be the whole result, with value > 0, the
    scene named and no fwd_bwd row; no detail file; K1 launches as its
    frames need), then the fwd+bwd row on the same scene with its own K1
    launches, then _bench_kernel once (with its "mixed" rows);
and the kernels' remaining modes:
44. the precision modes "high", "mixed" and "default" of every kernel:
    right after each kernel's check at "highest" (phases 3, 6 and 9, and
    the K4 check of 11), on the same main-path inputs, the kernel under each
    mode against its plain version at that mode (the plain version timed
    once; every bf16 mode runs on the tensor cores): K1 and K3 by the hit
    bar, and at "mixed" with t bit-equal wherever the triangle agrees; K2
    and K4 by the flag bar; and against its own "highest" result
    by the JAX package's near-parity
    bar (more than 99.5% of rays on the same triangle or flag; t to 1e-2
    under "high", bit-equal under "mixed"; "default" reported only, as the
    JAX package keeps it for diagnostics), with the median of 5 ms, its
    ratio to the "highest" time on the same inputs, the
    bound at the mode's own operation count (its bf16 products at the
    tensor cores' bf16 rate, its f32 adds at the f32 rate) and its share,
    and the instantiation's registers, CTAs per SM, HMMA and FFMA
    instructions (phase 2 prints every instantiation's); after
    phase 43, for each mode the config 3 stand-in's naive frame (800x800,
    spp 4, 4 bounces), the config 8 stand-in's NEE frame and the config 6
    stand-in's streamed NEE frame with kernel_precision set: launches,
    frame time, and the image against the "highest" frame by the image bar
    ("default" reported); then the bench's precision ladder rows
    (fwd_exact_precision, fwd_high_precision);
45. K3's traversal modes, right after phase 9's checks on its rays (the
    config 6 stand-in's camera and bounce-1 rays): the 7 cases of the JAX
    package's tests/test_stream_modes.py (budget, subtiles, fresh) through
    intersect_packed, each bit-identical to the single-phase search, with
    its K3 launches and its time against the single-phase time; one case at
    "mixed"; and K3 with a budget of 1 cluster and the done flags, exactly
    equal to its plain version, every live lane it reports done holding its
    single-phase triangle and some left undone; then the same budgeted
    search at "mixed" (K3's mode kernel on the tensor cores) against its
    plain version by the hit bar, t bit-equal where the triangle agrees;
46. right after phase 2: the PCG sampler's three kernels (csrc/pcg.cu:
    path keys, fold, and the draw at each width 1-4) at a frame's 640,000
    lanes against the plain int64 route on the same card tensors and on the
    CPU, bit for bit, with each one's device ms (CUDA events, mean of 200
    launches cycling through 150 MB of inputs and outputs, so that none
    finds them in L2), host ms a call, bytes bound at 3.35 TB/s, and the
    plain route's device and host ms (mean of 5 calls); phase 5 and every
    full frame also check the sampler's launches a frame against the count
    its spp, bounces, estimator and roulette give, and the shade kernel's
    against one a bounce of each sample where the frame takes it;
47. right after phase 46: the naive shade step's kernel (csrc/shade.cu) on
    the 640,000 lanes of bounce 1 of the config 3 and config 6 stand-ins,
    against the ops route on the same hits, bit for bit, with its device
    ms (CUDA events, mean of 200 launches cycling through 150 MB of inputs
    and outputs), host ms a call, bytes bound at 3.35 TB/s and registers,
    and both routes' render.shade spans split by the profiler (host ms,
    device ms and device ops a call, mean of 5) and their untraced wall ms
    a bounce (mean of 20 back to back);
48. right after phase 47: the search schedule's kernel (csrc/schedule.cu)
    through packed_intersect.prepare on the camera and bounce-1 rays of
    phases 3 and 9 (the config 3 stand-in's resident packs, tri_block 128
    and 512; the config 6 stand-in's streamed packs, 256 and 1024) against
    the torch ops on the same rays, bit for bit (order, entry bounds,
    enter_blk, features, lane values, padded rays), with its device ms
    (CUDA events, mean of 200 launches cycling through 150 MB of input
    rays), host ms a call, bytes bound at 3.35 TB/s and registers, and the
    torch ops' device and host ms (mean of 5 calls); every full frame also
    checks the schedule kernel's launches against one a search;
then the total wall time, a JSON line that summarises every kernel under
every mode, and a JSON result line last. Lines starting "elapsed:" mark
where the time of the run goes.

The naive path renders scenes/config3_icosphere.toml, the NEE path
scenes/config8_icosphere.toml and the streamed path
scenes/config6_icosphere.toml: configs 3, 8 and 6 with their OBJ meshes
replaced by icospheres, so the run needs no asset files. Config 5 is built
in code (grad/inverse.py) or read from scenes/config5_invert_target.toml.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import time
from functools import partial

import numpy as np
import torch

from gpupathtracer_tpu_torch import bench, cli, native
from gpupathtracer_tpu_torch.bench import bench_leaves, bench_loss_grads
from gpupathtracer_tpu_torch.grad.inverse import _demo_setup, camera_problem, run_inverse_demo, silhouette_problem
from gpupathtracer_tpu_torch.models.camera import generate_rays_for_pixels
from gpupathtracer_tpu_torch.models.materials import BxdfType
from gpupathtracer_tpu_torch.models.obj import MeshData
from gpupathtracer_tpu_torch.models.scene import build_scene, mesh_spec, plane_spec, sphere_spec
from gpupathtracer_tpu_torch.ops import _build, packed_intersect, shade
from gpupathtracer_tpu_torch.ops.compaction import compact_rays, compact_rays_coherent
from gpupathtracer_tpu_torch.ops.packed_intersect import (
    DEFAULT_RAY_TILE,
    STREAM_RAY_TILE,
    closest_hit,
    closest_hit_reference,
    closest_hit_streamed,
    closest_hit_streamed_reference,
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
from gpupathtracer_tpu_torch.render import integrator
from gpupathtracer_tpu_torch.render.integrator import (
    IntegratorOptions,
    init_path_state,
    light_table,
    make_bounce_fn,
    make_intersect_fn,
    shade_route,
)
from gpupathtracer_tpu_torch.render.film import to_u8
from gpupathtracer_tpu_torch.render.live import live_view
from gpupathtracer_tpu_torch.render.progressive import render_progressive
from gpupathtracer_tpu_torch.parallel.render import STRATEGIES, render_frame_distributed, scene_shard
from gpupathtracer_tpu_torch.render import renderer
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
        "library": "closest_hit",
    },
    "occluded": {
        "source": "gpupathtracer_tpu_torch/csrc/occlusion.cu",
        "replaces": "gpupathtracer_tpu/ops/pallas_intersect.py:882",
        "library": "occlusion",
    },
    "closest_hit_streamed": {
        "source": "gpupathtracer_tpu_torch/csrc/closest_hit_streamed.cu",
        "replaces": "gpupathtracer_tpu/ops/pallas_intersect.py:647",
        "library": "closest_hit_streamed",
    },
    "occluded_streamed": {
        "source": "gpupathtracer_tpu_torch/csrc/occlusion_streamed.cu",
        "replaces": "gpupathtracer_tpu/ops/pallas_intersect.py:960",
        "library": "occlusion_streamed",
    },
}

# The least time the card could take (H100 SXM data sheet, dense, at the
# 700 W limit): f32 outside the tensor cores, the precision the parity bar
# needs; bf16 on the tensor cores, the card's rate for a product of bf16
# values summed in f32; and device memory.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# Per (lane, triangle column) of a visited block: one multiply and one add
# for each of the 25 (scalar, feature row) slots that a packed column can
# hold nonzero. The other 55 are structural zeros, and the bound counts what
# these inputs need, as for a sparse product, not the dense 5 x 16 product.
FLOP_PER_PAIR = 2 * len(LIVE_SLOTS)
# The bf16 precision modes (packed_intersect.PRECISIONS) and their FLOP per
# pair as (f32, bf16), counted as FLOP_PER_PAIR is: a multiply and an add
# per FMA of each bf16 product chain (one for "default"; three for a split
# slot: the 25 live slots for "high", the 18 edge slots for "mixed"),
# priced at the bf16 rate; the two f32 adds that fold a split scalar's
# chains (5 scalars for "high", 3 for "mixed") and "mixed"'s f32 D|num
# slots, at the f32 rate. Every kernel runs the products on the tensor
# cores (mma.sync m16n8k8 over 8-row windows, whose zero rows the bound
# does not count).
PRECISION_MODES = ("high", "mixed", "default")
FLOP_PER_PAIR_AT = {
    "highest": (FLOP_PER_PAIR, 0),
    "high": (2 * 5, 2 * 3 * len(LIVE_SLOTS)),
    "mixed": (2 * 3 + 2 * (len(LIVE_SLOTS) - 18), 2 * 3 * 18),
    "default": (0, FLOP_PER_PAIR),
}
# The JAX package's near-parity bar of a bf16 mode against "highest"
# (tests/test_pallas_kernel.py): more than 99.5% of rays on the same
# triangle, t to rtol = atol = 1e-2 ("high") or bit-equal ("mixed"). Its
# "default" is for diagnostics only and has no bar: reported, not held.
NEAR_AGREE = 0.995
NEAR_T_TOL = 1e-2

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
    report, by mangled entry name, with its spill stores where there are
    any."""
    usage, entry, spill = {}, None, 0
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            entry, spill = ln.split("'")[1], 0
        elif "bytes spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif "Used" in ln and entry is not None:
            usage[entry] = ln.split("info    :")[-1].strip() + (f", {spill} bytes spill stores" if spill else "")
    return usage


# ptxas's report of each library phase_build built, by name.
BUILD_REPORTS: dict[str, str] = {}


def phase_build() -> None:
    t0 = time.perf_counter()
    reports = _build.build()
    BUILD_REPORTS.update(reports)
    for name in reports:
        _build.library(name)
    dt = time.perf_counter() - t0
    parts = []
    for name, report in reports.items():
        usage = " ".join(ln.split("info    :")[-1].strip() for ln in report.splitlines() if "Used" in ln)
        parts.append(f"{os.path.relpath(_build.source(name), ROOT)} -> "
                     f"{os.path.relpath(_build.library_path(name), ROOT)} ({usage})")
    print(f"build: nvcc, {len(reports)} sources in parallel, {dt:.2f} s: " + "; ".join(parts), flush=True)
    sass = {name: sass_counts(name) for name in reports}
    for name in _build.OCCUPANCY:
        ray_tile = STREAM_RAY_TILE if name.endswith("_streamed") else DEFAULT_RAY_TILE
        for precision in packed_intersect.PRECISIONS:
            for modes in (False, True) if name == "closest_hit_streamed" else (False,):
                occ = packed_intersect.launch_occupancy(name, ray_tile, precision, modes)
                # The entries are templates on rays a thread (K1 and K3 at
                # highest), the precision and m-tiles a warp (the four
                # tensor-core kernels at the bf16 modes), K3's modes and
                # K3's and K4's test count: <rpt>, <p, mt>,
                # <rpt, modes, count>, <p, mt, modes, count>, <count> and
                # <p, mt, count> in their mangled names, the untraced
                # instantiations (count false) here; K2's "highest" kernel
                # is no template (the name's end, then the parameters).
                p = packed_intersect.PRECISIONS.index(precision)
                modes_arg = {"closest_hit_streamed": f"Lb{int(modes)}ELb0E", "occlusion_streamed": "Lb0E"}.get(name, "")
                if occ["route"] == "mma":
                    entry = f"{name}_mma_kernelILi{p}ELi{occ['m_tiles_per_warp']}E{modes_arg}E"
                elif name.startswith("closest_hit"):
                    entry = f"{name}_kernelILi{occ['rays_per_thread']}E{modes_arg}E"
                elif modes_arg:
                    entry = f"{name}_kernelI{modes_arg}E"
                else:
                    entry = f"{len(name) + 7}{name}_kernelEP"
                occ["modes"] = modes
                occ["ptxas"] = "; ".join(u for e, u in ptxas_usage(reports[name]).items() if entry in e)
                if not occ["ptxas"]:
                    raise AssertionError(f"no ptxas report of {entry} in the build of {name}")
                found = [c for e, c in sass[name].items() if entry in e]
                if len(found) != 1:
                    raise AssertionError(f"{len(found)} SASS functions of {entry} in the build of {name}")
                occ.update(hmma=found[0]["HMMA"], ffma=found[0]["FFMA"])
                if occ["route"] == "mma" and not occ["hmma"]:
                    raise AssertionError(f"{entry} at {precision} has no HMMA instruction: {occ}")
                OCCUPANCY_ROWS[(name, precision, modes)] = occ
                print(f"occupancy {name}: {json.dumps(occ)}", flush=True)
    # Every instantiation, the two m-tiles a warp of the bf16 kernels too.
    for name, counts in sass.items():
        print(f"sass {name} (bar: HMMA in every tensor-core kernel): {json.dumps(counts)}", flush=True)
        missing = [e for e, c in counts.items() if "_mma_kernel" in e and not c["HMMA"]]
        if missing:
            raise AssertionError(f"{name}: no HMMA instruction in {missing}")


def sass_counts(name: str) -> dict:
    """The HMMA (tensor-core) and FFMA (f32 FMA) instructions of each
    kernel entry in the built library ``name``, by mangled name, from
    ``cuobjdump -sass`` of the CUDA toolkit that built it."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", _build.library_path(name)], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, entry = {}, None
    for ln in out.splitlines():
        head = re.search(r"Function : (\S+)", ln)
        if head:
            entry = head.group(1)
            counts[entry] = {"HMMA": 0, "FFMA": 0}
            continue
        op = re.search(r"\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if entry is not None and op:
            for key in counts[entry]:
                counts[entry][key] += op.group(1).startswith(key)
    if not counts:
        raise AssertionError(f"cuobjdump -sass found no function in {_build.library_path(name)}")
    return counts


# Each kernel instantiation's occupancy row (phase_build), by (library,
# precision, modes).
OCCUPANCY_ROWS = {}


def phase_live_zeros(label: str, packed) -> None:
    """The w that the kernels get from this pack (the pack's own on the
    resident route, padded to whole clusters on the streamed one) is exactly
    zero outside LIVE_SLOTS and finite everywhere (they read only the live
    slots); checked on the pack's device, once per pack."""
    way = packed_intersect.route(packed.w.shape[0], packed.tri_block)
    route = "streamed" if way.streamed else "resident"
    w = packed_intersect._pad_blocks(packed, way.bpc).w if way.streamed else packed.w
    nb, tb = w.shape[0], w.shape[2] // NSCALARS
    row = {"blocks": nb, "tri_block": tb, "slots_outside": K * NSCALARS - len(LIVE_SLOTS),
           "nonzero_outside": int((packed_intersect.outside_live_slots(w) != 0).sum()),
           "finite": bool(torch.isfinite(w).all())}
    print(f"live slots, {route} pack {label} (bar: nonzero_outside = 0, finite): {json.dumps(row)}", flush=True)
    if row["nonzero_outside"] or not row["finite"]:
        raise AssertionError(f"the {route} pack {label} breaks the live-slot contract: {row}")


def bound(flop: float, nbytes: float, bf16_flop: float = 0) -> dict:
    """The least time for ``flop`` f32 and ``bf16_flop`` bf16 operations
    moving ``nbytes``, and which of the two bounds it. The tensor cores and
    the f32 units run side by side, so the operations take the longer of
    the two types' times."""
    t_ops = max(flop / PEAK_F32_FLOPS, bf16_flop / PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return {
        "flop": flop, "bf16_flop": bf16_flop, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
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

    def capture(*args, **kwargs):
        captured.append(args)
        return plain(*args, **kwargs)

    # The search is looked up when it is called.
    setattr(packed_intersect, plain_name, capture)
    try:
        bounce1(state, 1)
    finally:
        setattr(packed_intersect, plain_name, plain)
    if len(captured) != 1:
        raise AssertionError(f"bounce 1 cast {len(captured)} shadow-ray batches through {plain_name}, expected 1")
    return captured[0]


def hit_check(name: str, label: str, kernel, plain, args, packed, reps: int = 5, exact: bool = False,
              rows_exact: bool = False, t_exact: bool = False, plain_reps: int | None = None,
              flop_per_pair: tuple[int, int] = FLOP_PER_PAIR_AT["highest"]) -> dict:
    """A closest-hit kernel against its plain version on the same inputs;
    ``exact`` also requires the same packed row and a bit-equal t on every
    lane, ``rows_exact`` the same packed row only, ``t_exact`` a bit-equal
    t wherever the triangle agrees. The plain version is
    timed over ``plain_reps`` runs (``reps`` unless given; 0: the one run
    that counts its work). The bound counts ``flop_per_pair`` (f32, bf16)."""
    device = args[0].device
    bt_k, bi_k = kernel(*args)
    _sync(device)
    t0 = time.perf_counter()
    bt_r, bi_r, work = plain(*args, count_work=True)
    _sync(device)
    plain_once_ms = (time.perf_counter() - t0) * 1e3
    tri_map = lambda bi: torch.where(bi >= 0, packed.tri_map[bi.long().clamp(min=0)], -1)
    tri_k, tri_r = tri_map(bi_k), tri_map(bi_r)
    agree = (tri_k == tri_r).double().mean().item()
    same = (tri_k == tri_r) & (bi_r >= 0)
    err = (bt_k[same] - bt_r[same]).abs()
    max_abs_err = err.max().item() if err.numel() else 0.0
    t_ok = bool((err <= T_TOL + T_TOL * bt_r[same].abs()).all())
    t_equal_same_tri = bool(torch.equal(bt_k[same], bt_r[same]))
    same_row = (bi_k == bi_r).double().mean().item()
    t_equal = bool(torch.equal(bt_k, bt_r))
    kernel_ms = median_ms(lambda: kernel(*args), device, reps)
    plain_ms = plain_once_ms if plain_reps == 0 else median_ms(lambda: plain(*args), device, plain_reps or reps)
    pairs = work["lane_blocks"] * packed.tri_block
    b = bound(flop_per_pair[0] * pairs, _nbytes(*args, bt_k, bi_k), flop_per_pair[1] * pairs)
    ray_tile = args[-1]
    row = {
        "rays": args[-4].shape[0], "tri_block": packed.tri_block,
        "ray_tile": ray_tile, "blocks_per_schedule_entry": args[-2].shape[0] // args[0].shape[1],
        "hit_share": (bi_r >= 0).double().mean().item(), "same_tri": agree, "max_abs_err": max_abs_err,
        "same_row": same_row, "t_equal": t_equal, "t_equal_same_tri": t_equal_same_tri,
        "ms": kernel_ms, "plain_ms": plain_ms, "visited_blocks": work["blocks"],
        "lane_blocks": work["lane_blocks"], **b,
    }
    bar = f"same_tri >= {HIT_AGREE}, |dt| <= {T_TOL} + {T_TOL}|t|"
    bar += "; exact: same_tri = same_row = 1, max_abs_err = 0, t_equal" if exact else ""
    bar += "; same_row = 1" if rows_exact else ""
    bar += "; t_equal_same_tri" if t_exact else ""
    print(f"{name} {label} (bar: {bar}): {json.dumps(row)}", flush=True)
    if agree < HIT_AGREE or not t_ok:
        raise AssertionError(f"{name} {label} misses the hit parity bar: same_tri {agree}, t ok {t_ok}")
    if exact and not (agree == 1.0 and same_row == 1.0 and max_abs_err == 0.0 and t_equal):
        raise AssertionError(f"{name} {label} is not exact: same_tri {agree}, same_row {same_row}, "
                             f"max_abs_err {max_abs_err}, t_equal {t_equal}")
    if rows_exact and same_row != 1.0:
        raise AssertionError(f"{name} {label}: same_row {same_row}, expected 1")
    if t_exact and not t_equal_same_tri:
        raise AssertionError(f"{name} {label}: t differs where the triangle agrees (max_abs_err {max_abs_err})")
    return row


# Runs that time the plain version in a check whose plain time no summary
# reads (the scene-shard and mask-mode checks): one, to keep the script
# well inside its time limit.
PLAIN_REPS_UNREPORTED = 1


def phase_kernel_check(label: str, o, d, packed, plain_reps: int | None = None) -> dict:
    """K1 against closest_hit_reference at its main-path shapes."""
    args = prepare_rays(o, d, packed) + (packed.w, DEFAULT_RAY_TILE)
    return hit_check("closest_hit", label, closest_hit, closest_hit_reference, args, packed, exact=True,
                     plain_reps=plain_reps)


def phase_streamed_check(label: str, o, d, packed, rows_exact: bool = False, plain_reps: int | None = None) -> dict:
    """K3 against closest_hit_streamed_reference at its main-path shapes."""
    if not packed_intersect.route(packed.w.shape[0], packed.tri_block).streamed:
        raise AssertionError(f"the streamed check needs a pack past the resident budget ({label})")
    args = prepare_rays_streamed(o, d, packed) + (STREAM_RAY_TILE,)
    return hit_check("closest_hit_streamed", label, closest_hit_streamed, closest_hit_streamed_reference, args, packed,
                     rows_exact=rows_exact, plain_reps=plain_reps)


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


def occlusion_check(name: str, label: str, kernel, plain, args, reps: int = 5, exact: bool = False,
                    plain_reps: int | None = None,
                    flop_per_pair: tuple[int, int] = FLOP_PER_PAIR_AT["highest"]) -> dict:
    """An any-hit kernel against its plain version on the same inputs;
    ``exact`` requires every flag equal. The plain version is timed over
    ``plain_reps`` runs (``reps`` unless given; 0: the one run that counts
    its work). The bound counts ``flop_per_pair`` (f32, bf16)."""
    feats, maxt, w = args[-4], args[-3], args[-2]
    device = feats.device
    occ_k = kernel(*args)
    _sync(device)
    t0 = time.perf_counter()
    occ_r, work = plain(*args, count_work=True)
    _sync(device)
    plain_once_ms = (time.perf_counter() - t0) * 1e3
    agree = (occ_k == occ_r).double().mean().item()
    dead_occluded = int((occ_k[maxt == 0] != 0).sum())
    kernel_ms = median_ms(lambda: kernel(*args), device, reps)
    plain_ms = plain_once_ms if plain_reps == 0 else median_ms(lambda: plain(*args), device, plain_reps or reps)
    tb = w.shape[2] // NSCALARS
    pairs = work["lane_blocks"] * tb
    b = bound(flop_per_pair[0] * pairs, _nbytes(*args, occ_k), flop_per_pair[1] * pairs)
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
    all else (and of the PCG sampler's kernels, which all else holds); with
    ``top``, also the ``top`` costliest kernel names, and with
    ``trace_path``, the Chrome trace written there."""
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
    out["pcg_ms"] = sum(v for k, v in by_name.items() if "pcg_" in k)
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


def frame_shade_fused(scene, settings) -> bool:
    """Whether a frame of ``settings`` on ``scene``, with no input that
    requires a gradient, shades through the fused kernel
    (``integrator.shade_route`` on the settings ``render_frame`` narrows)."""
    opts = renderer._integrator_options(narrow_settings(scene, settings))
    return shade_route(opts, scene.v0.device) == "fused"


def expect_pcg_launches(settings, fused: bool = False) -> int:
    """The PCG sampler's kernel launches in one frame of ``settings``: per
    sample the path keys, the jitter's fold and draw (spp > 1 with jitter),
    and on the ops route per bounce a fold and a draw, and one of each more
    for the light sample (NEE and MIS) and for Russian roulette (from
    ``rr_start``). A ``fused`` frame's shade kernel draws the bounces' own."""
    if settings.rng != "pcg":
        return 0
    jitter = 2 if settings.jitter and settings.spp > 1 else 0
    if fused:
        return settings.spp * (1 + jitter)
    nee = 2 if settings.estimator in ("nee", "mis") else 0
    rr = 0 if settings.rr_start is None else 2 * max(0, settings.bounces - settings.rr_start)
    return settings.spp * (1 + jitter + settings.bounces * (2 + nee) + rr)


def expect_shade_launches(settings, fused: bool) -> int:
    """The shade kernel's launches in one frame: one a bounce of each
    sample where the frame takes it."""
    return settings.spp * settings.bounces if fused else 0


def expect_schedule_launches(expect: dict) -> int:
    """The schedule kernel's launches in one frame of the search launches
    ``expect``: one a search, each of whose schedules is one launch."""
    return sum(expect.values())


# Each full frame's PCG, shade-kernel and schedule-kernel launches by its
# label, for the summary line.
PCG_LAUNCHES_BY_PATH: dict[str, int] = {}
SHADE_LAUNCHES_BY_PATH: dict[str, int] = {}
SCHEDULE_LAUNCHES_BY_PATH: dict[str, int] = {}


def phase_full_frame(label: str, scene, camera, settings, expect: dict, frames: int = 3, profiled: bool = False) -> dict:
    """A path at full size: launches of each kernel, of the PCG sampler, the
    shade step and the schedule in one frame (the counts set to 0 just
    before it) against their expected counts, a finite image, frame time;
    optionally one more frame under the profiler."""
    device = scene.v0.device
    for k in KERNELS.values():
        _build.launch_counts[k["library"]] = 0
    before = {lib: _build.launch_counts[lib] for lib in (_build.PCG, _build.SHADE, _build.SCHEDULE)}
    img = render_frame(scene, camera, settings)
    _sync(device)
    launches = {name: _build.launch_counts[k["library"]] for name, k in KERNELS.items()}
    pcg_launches, shade_launches, schedule_launches = (_build.launch_counts[lib] - n for lib, n in before.items())
    mean = img.mean().item()
    if launches != expect:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expect}")
    fused = frame_shade_fused(scene, settings)
    if pcg_launches != expect_pcg_launches(settings, fused):
        raise AssertionError(f"{label}: {pcg_launches} PCG launches, expected "
                             f"{expect_pcg_launches(settings, fused)}")
    if shade_launches != expect_shade_launches(settings, fused):
        raise AssertionError(f"{label}: {shade_launches} shade launches, expected "
                             f"{expect_shade_launches(settings, fused)}")
    if schedule_launches != expect_schedule_launches(expect):
        raise AssertionError(f"{label}: {schedule_launches} schedule launches, expected "
                             f"{expect_schedule_launches(expect)}")
    PCG_LAUNCHES_BY_PATH[label] = pcg_launches
    SHADE_LAUNCHES_BY_PATH[label] = shade_launches
    SCHEDULE_LAUNCHES_BY_PATH[label] = schedule_launches
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
    out = {"launches": launches, "pcg_launches": pcg_launches, "shade_launches": shade_launches,
           "schedule_launches": schedule_launches, "image_mean": mean, "frame_s": frame_s,
           "frame_s_all": times, "rays_per_s": rays / frame_s}
    if profiled:
        out["profile"] = profile_frame(lambda: float(render_frame(scene, camera, settings, seed=999).sum()))
    shadow = " (shadow rays not counted)" if settings.estimator != "naive" else ""
    print(
        f"frame, {label} path, {settings.width}x{settings.height} spp {settings.spp} "
        f"bounces {settings.bounces}, rays = W*H*spp*bounces{shadow}: {json.dumps(out)}",
        flush=True,
    )
    return out


# A config 3 stand-in frame's lanes (800x800): the width of every sampler
# call of its camera rays and of each bounce before compaction.
PCG_LANES = 640_000
# The bytes of input copies a timed loop of phase 46 cycles through, and of
# the outputs it keeps alive: three times the H100's 50 MB L2, so each launch
# reads its inputs from device memory and writes its outputs to fresh lines,
# as a frame's launches do.
PCG_ROTATE_BYTES = 150_000_000


def _device_and_host_ms(fn, reps: int) -> tuple[float, float]:
    """Mean device ms a call of ``fn()`` (CUDA events around ``reps`` calls,
    after a warm-up) and mean host ms a call over the same loop. The loop is
    queued behind a ~0.1 s sleep on the device, so the events time the
    calls' device work back to back and the host times its own dispatch,
    never waiting for the device (keep ``reps`` calls' launches under the
    launch queue's ~1,000)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def rotating(call, x: torch.Tensor):
    """``call`` as a function of no arguments that takes the next of enough
    copies of ``x`` to fill PCG_ROTATE_BYTES each time, and keeps that many
    of its results alive, so no launch finds its input or output in L2. The
    results are made once here (one call a copy), so the timed calls take
    their outputs from the allocator's cache."""
    copies = [x.clone() for _ in range(max(2, -(-PCG_ROTATE_BYTES // (x.numel() * x.element_size()))))]
    outs, i = [call(c) for c in copies], [0]

    def step():
        k = i[0] % len(copies)
        outs[k] = call(copies[k])
        i[0] += 1

    return step


def phase_pcg(device) -> list:
    """Phase 46: the PCG sampler's kernels against the plain int64 route at
    PCG_LANES lanes, bit for bit on the card and against the CPU, timed with
    their inputs and outputs in device memory (``rotating``)."""
    from gpupathtracer_tpu_torch.ops import sampling

    pixels = torch.arange(PCG_LANES, device=device)
    key_data = prng_key_data(1234)
    keys = PcgSampler.path_keys(key_data, pixels, 3)
    folded = PcgSampler.fold(keys, 0xA11A)
    seed, sample = int(keys[0, 0]), 3
    cases = [("path_keys", lambda p: PcgSampler.path_keys(key_data, p, sample), pixels,
              lambda: sampling._path_keys_plain(pixels, seed, sample),
              lambda: PcgSampler.path_keys(key_data, pixels.cpu(), sample), 8 + 32),
             ("fold", lambda k: PcgSampler.fold(k, 0xA11A), keys, lambda: sampling._fold_plain(keys, 0xA11A),
              lambda: PcgSampler.fold(keys.cpu(), 0xA11A), 32 + 32)]
    for n in (1, 2, 3, 4):
        cases.append((f"uniform n={n}", lambda k, n=n: PcgSampler.uniform(k, n), folded,
                      partial(sampling._uniform_plain, folded, n), partial(PcgSampler.uniform, folded.cpu(), n),
                      32 + 4 * n))
    rows = []
    for name, kernel, x, plain, cpu, lane_bytes in cases:
        got, on_card, want = kernel(x), plain(), cpu()
        torch.cuda.synchronize()
        if not (torch.equal(got, on_card) and torch.equal(got.cpu(), want)):
            raise AssertionError(f"pcg {name}: the kernel's output differs from the plain route's")
        step = rotating(kernel, x)
        before = _build.launch_counts[_build.PCG]
        ms, host_ms = _device_and_host_ms(step, 200)
        if _build.launch_counts[_build.PCG] - before != 201:
            raise AssertionError(f"pcg {name}: {_build.launch_counts[_build.PCG] - before} launches in 201 calls")
        plain_ms, plain_host_ms = _device_and_host_ms(plain, 5)
        b = bound(0, PCG_LANES * lane_bytes)
        rows.append({"name": f"pcg {name}", "lanes": PCG_LANES, "ms": ms, "host_ms": host_ms,
                     "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "share_of_bound": b["bound_ms"] / ms,
                     "plain_ms": plain_ms, "plain_host_ms": plain_host_ms, "exact": True})
    print(f"pcg kernels (csrc/pcg.cu) at {PCG_LANES} lanes, bit-equal to the plain route: {json.dumps(rows)}",
          flush=True)
    return rows


# Bytes a lane of the shade step moves once: it reads o, d, throughput and
# radiance (48), alive and hit (2), its row index (8) and key (32), and
# writes o, d, throughput and radiance (48), alive and prev_nee (2) and
# prev_pdf (4); and a scene row it gathers: v0, e1, e2 (36) and mat_id (8).
SHADE_READ_BYTES, SHADE_WRITE_BYTES = 48 + 2 + 8 + 32, 48 + 2 + 4
SHADE_ROW_BYTES = 36 + 8
SHADE_INPUTS = ("o", "d", "throughput", "radiance", "alive", "keys")


def shade_inputs(path, device):
    """A stand-in's scene, its integrator options as render_frame narrows
    them, and sample 1's path state before bounce 1 over the camera's
    640,000 lanes (bounce 0 uncompacted, as the render runs it), with that
    bounce's closest hits."""
    scene, camera, settings = load_scene_file(path, device=device)
    settings = dataclasses.replace(narrow_settings(scene, settings), spp=4)
    opts = renderer._integrator_options(settings)
    packed = pack_scene(scene, tri_block=settings.tri_block)
    pixels = torch.arange(settings.width * settings.height, device=device)
    o, d, keys = renderer.sample_rays(camera, pixels, settings, prng_key_data(1234), 1)
    state = make_bounce_fn(scene, opts, packed=packed)(init_path_state(o, d, keys), 0, compact_now=False)
    hit = make_intersect_fn(scene, opts, packed=packed)(state.o, state.d, alive=state.alive)
    return scene, opts, state, hit


def _wall_ms(step, state, reps: int = 20) -> float:
    """Host ms a bounce of ``step`` (its search a fixed answer) over
    ``reps`` calls back to back, untraced, to the device's end: the host's
    dispatch where it exceeds the device's work."""
    step(state, 1, compact_now=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(state, 1, compact_now=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_shade(device) -> list:
    """Phase 47: the naive shade step's kernel (csrc/shade.cu) on bounce 1
    of the config 3 and config 6 stand-ins, against the ops route on the
    same hits, bit for bit; its device ms with its inputs and outputs in
    device memory (``rotating``'s rule), both routes' render.shade spans
    split by the profiler, and both routes' untraced wall ms a bounce."""
    floats = ("o", "d", "throughput", "radiance", "prev_pdf")
    ops_route = lambda *args: "ops"
    rows = []
    for label, path in (("config3", SCENE), ("config6", STREAM_SCENE)):
        scene, opts, state, hit = shade_inputs(path, device)
        lanes = state.d.shape[0]
        if shade_route(opts, state.d.device) != "fused":
            raise AssertionError(f"shade {label}: the naive frame does not take the fused route")
        step = make_bounce_fn(scene, opts, intersect_fn=lambda o, d, alive=None, hit=hit: hit)
        run = lambda: [step(state, 1, compact_now=False) for _ in range(5)]
        fused = step(state, 1, compact_now=False)
        integrator.shade_route = ops_route
        try:
            ops = step(state, 1, compact_now=False)
            ops_split = span_times(run, ["render.shade"])["render.shade"]
            ops_wall_ms = _wall_ms(step, state)
        finally:
            integrator.shade_route = shade_route
        fused_split = span_times(run, ["render.shade"])["render.shade"]
        fused_wall_ms = _wall_ms(step, state)
        torch.cuda.synchronize()
        same = [torch.equal(fused.alive, ops.alive), torch.equal(fused.prev_nee, ops.prev_nee)]
        same += [torch.equal(getattr(fused, f).view(torch.int32), getattr(ops, f).view(torch.int32)) for f in floats]
        if not all(same):
            raise AssertionError(f"shade {label}: the kernel's next state differs from the ops route's: {same}")
        per_copy = lanes * SHADE_READ_BYTES
        copies = [({f: getattr(state, f).clone() for f in SHADE_INPUTS}, hit.tri.clone(), hit.hit.clone())
                  for _ in range(max(2, -(-PCG_ROTATE_BYTES // per_copy)))]
        call = lambda c: shade.naive_shade(c[0]["o"], c[0]["d"], c[0]["throughput"], c[0]["radiance"],
                                           c[0]["alive"], integrator.Hit(t=hit.t, tri=c[1], hit=c[2]), c[0]["keys"],
                                           scene, opts.background, 1, True, True, False, False)
        outs, i = [call(c) for c in copies], [0]

        def timed():
            k = i[0] % len(copies)
            outs[k] = call(copies[k])
            i[0] += 1

        before = _build.launch_counts[_build.SHADE]
        ms, host_ms = _device_and_host_ms(timed, 200)
        if _build.launch_counts[_build.SHADE] - before != 201:
            raise AssertionError(f"shade {label}: {_build.launch_counts[_build.SHADE] - before} launches in 201 calls")
        rows_read = int(torch.unique(hit.tri.clamp(min=0)).numel())
        b = bound(0, lanes * (SHADE_READ_BYTES + SHADE_WRITE_BYTES) + rows_read * SHADE_ROW_BYTES)
        per_call = lambda t: {"host_ms": t["host_s"] * 1e3 / t["count"], "device_ms": t["device_s"] * 1e3 / t["count"],
                              "device_ops": t["device_ops"] / t["count"]}
        rows.append({"name": f"shade naive {label}", "lanes": lanes, "live": int(state.alive.sum()),
                     "rows_read": rows_read, "ms": ms, "host_ms": host_ms, "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"], "share_of_bound": b["bound_ms"] / ms,
                     "fused_span": per_call(fused_split), "ops_span": per_call(ops_split),
                     "fused_wall_ms": fused_wall_ms, "ops_wall_ms": ops_wall_ms,
                     "ptxas": ptxas_usage(BUILD_REPORTS.get(_build.SHADE, "")), "exact": True})
    print(f"shade kernel (csrc/shade.cu) at bounce 1, bit-equal to the ops route: {json.dumps(rows)}", flush=True)
    return rows


# Bytes a search's schedule moves once: a lane reads o and d (24) and
# writes its features and lane value (68), and o and d again where the rays
# are padded (24); a tile writes each key's order and entry bound (8) and, on
# the streamed route, each block's entry bound (4); each block's box and
# live flag are read (25).
SCHEDULE_LANE_BYTES, SCHEDULE_PAD_BYTES = 24 + 68, 24
SCHEDULE_KEY_BYTES, SCHEDULE_BLOCK_BYTES, SCHEDULE_BOX_BYTES = 8, 4, 25


def _schedule_bits(prepared) -> list:
    """``prepare``'s rays and every search input but w, floats as their bits."""
    o, d, _, inputs = prepared
    return [x.view(torch.int32) if x.dtype == torch.float32 else x for x in (o, d) + inputs[:-1]]


def phase_schedule(device) -> list:
    """Phase 48: the search schedule's kernel (csrc/schedule.cu) through
    ``prepare`` on the camera and bounce-1 rays of the config 3 stand-in
    (resident packs) and the config 6 stand-in (streamed packs), against the
    torch ops on the same rays, bit for bit; its device ms with its input
    rays cycled through PCG_ROTATE_BYTES and its outputs kept alive, against
    the bytes bound, its host ms a call, and the torch ops' device and host
    ms."""
    rule, ops_route = packed_intersect.schedule_route, lambda *args: "ops"
    rows = []
    for label, path in (("config3", SCENE), ("config6", STREAM_SCENE)):
        scene, camera, settings = load_scene_file(path, device=device)
        packs = [pack_scene(scene, tri_block=tb) for tb in (settings.tri_block, settings.tri_block_secondary)]
        for rays, (o, d), packed in zip(("camera", "bounce-1"), main_path_rays(scene, camera, settings, packs[0]),
                                        packs):
            way = packed_intersect.route(packed.w.shape[0], packed.tri_block)
            call = lambda c, packed=packed, way=way: packed_intersect.prepare(c[0], c[1], None, packed, way)
            got = call((o, d))
            packed_intersect.schedule_route = ops_route
            try:
                want = call((o, d))
                ops_ms, ops_host_ms = _device_and_host_ms(lambda: call((o, d)), 5)
            finally:
                packed_intersect.schedule_route = rule
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(_schedule_bits(got), _schedule_bits(want))]
            if not all(same):
                raise AssertionError(f"schedule {label} {rays}: the kernel's inputs differ from the torch ops': {same}")
            copies = [(o.clone(), d.clone()) for _ in range(max(2, -(-PCG_ROTATE_BYTES // (2 * o.nbytes))))]
            outs, i = [call(c) for c in copies], [0]

            def timed():
                k = i[0] % len(copies)
                outs[k] = call(copies[k])
                i[0] += 1

            before = _build.launch_counts[_build.SCHEDULE]
            ms, host_ms = _device_and_host_ms(timed, 200)
            if _build.launch_counts[_build.SCHEDULE] - before != 201:
                raise AssertionError(f"schedule {label} {rays}: "
                                     f"{_build.launch_counts[_build.SCHEDULE] - before} launches in 201 calls")
            del outs, copies
            order, r_pad, nb = got[3][0], got[3][-2].shape[0], got[2].w.shape[0]
            tiles, keys = order.shape
            nbytes = r_pad * (SCHEDULE_LANE_BYTES + (SCHEDULE_PAD_BYTES if r_pad != o.shape[0] else 0))
            nbytes += tiles * (keys * SCHEDULE_KEY_BYTES + (nb * SCHEDULE_BLOCK_BYTES if way.streamed else 0))
            b = bound(0, nbytes + nb * SCHEDULE_BOX_BYTES)
            rows.append({"name": f"schedule {label} {rays}", "rays": o.shape[0],
                         "route": "streamed" if way.streamed else "resident", "tri_block": packed.tri_block,
                         "tiles": tiles, "keys": keys, "blocks": nb, "scheduled": int((order < keys).sum()),
                         "ms": ms, "host_ms": host_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                         "share_of_bound": b["bound_ms"] / ms, "ops_ms": ops_ms, "ops_host_ms": ops_host_ms,
                         "ptxas": ptxas_usage(BUILD_REPORTS.get(_build.SCHEDULE, "")), "exact": True})
    print(f"schedule kernel (csrc/schedule.cu) on the main-path rays, bit-equal to the torch ops: {json.dumps(rows)}",
          flush=True)
    return rows


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


def _launch_counts() -> dict:
    return {name: _build.launch_counts[k["library"]] for name, k in KERNELS.items()}


def _reset_launches() -> None:
    for k in KERNELS.values():
        _build.launch_counts[k["library"]] = 0


def phase_grad_check(label: str, scene, camera, settings, expect: dict) -> dict:
    """Gradients of the bench loss in (v0, albedo) through the kernels and
    through the plain versions (intersector "plucker"): the hits are the
    same, so they agree within rtol 1e-4 and atol 1e-6*max|g| (only the
    order of the scatter-adds backwards differs). Also the kernel launches
    of the kernel run, as expected."""
    leaf, leaves = bench_leaves(scene)
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
    leaf, leaves = bench_leaves(scene)
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
        row = hit_check(name, label, closest_hit, closest_hit_reference, args, packed2, exact=True,
                        plain_reps=PLAIN_REPS_UNREPORTED)
    else:
        args = prepare_rays_streamed(state.o, state.d, packed2, alive=state.alive) + (STREAM_RAY_TILE,)
        row = hit_check(name, label, closest_hit_streamed, closest_hit_streamed_reference, args, packed2, exact=True,
                        plain_reps=PLAIN_REPS_UNREPORTED)
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
    (2 frames, spp 1, --gif: two PNGs and a turntable.gif of 2 frames) and
    the config 5 trainer through the CLI (3 steps)."""
    from PIL import Image  # --gif needs it
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
        view_rc = cli.main(["view", SCENE, "--frames", "2", "--spp", "1", "--gif", "--out", os.path.join(tmp, "turn")])
        view = {"rc": view_rc, "launches": _launch_counts(), "frames": sorted(os.listdir(os.path.join(tmp, "turn")))}
        with Image.open(os.path.join(tmp, "turn", "turntable.gif")) as gif:
            view["gif"] = {"frames": gif.n_frames, "size": list(gif.size), "duration": gif.info.get("duration")}
        _reset_launches()
        invert_rc = cli.main(["invert", "--steps", "3"])
        invert = {"rc": invert_rc, "launches": _launch_counts()}
    expect_live = expect_launches(closest_hit=3 * 2 * settings.bounces)
    expect_view = expect_launches(closest_hit=2 * settings.bounces)
    spp5, bounces5 = 8, 2  # the trainer's defaults: (steps + 1) frames of spp x 2 x bounces K1 launches
    expect_invert = expect_launches(closest_hit=4 * spp5 * 2 * bounces5)
    row = {"live": live, "view": view, "invert": invert}
    print(f"live view and CLI view/invert, config3 800x800 (bar: live {expect_live}, spp 4, moved 0.2, status spp 4; "
          f"view rc 0, {expect_view}, 2 PNGs and a GIF of 2 frames; invert rc 0, {expect_invert}): "
          f"{json.dumps(row)}", flush=True)
    ok = (live["launches"] == expect_live and spp == 4 and abs(live["moved_z"] - 0.2) < 1e-5
          and live["status"]["spp"] == 4 and view_rc == 0 and view["launches"] == expect_view
          and len(view["frames"]) == 3 and view["gif"]["frames"] == 2 and invert_rc == 0
          and invert["launches"] == expect_invert)
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


def phase_native_build() -> dict:
    """The host library (csrc/firefly_native.cpp: OBJ, BVH and edge-table
    builders) compiled from this checkout by the host C++ compiler, timed
    from scratch."""
    t0 = time.perf_counter()
    path = native.build_library(force=True)
    row = {"source": os.path.relpath(_build.HOST_SOURCE, ROOT), "library": os.path.relpath(path, ROOT),
           "compiler": _build.HOST_CXX, "flags": _build.HOST_CXX_FLAGS, "build_s": time.perf_counter() - t0}
    print(f"build: host library {json.dumps(row)}", flush=True)
    return row


def phase_host_builders(scene) -> dict:
    """The config 6 stand-in's edge table and BVH through the native
    builders and the Python ones: seconds of each, and the arrays equal
    element for element. The Python BVH is built through the renderer's
    cache, so the BVH frames of this scene reuse it."""
    from gpupathtracer_tpu_torch.grad import edges

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    e_nat, e_nat_s = timed(lambda: edges.build_edge_table(scene))
    e_py, e_py_s = timed(lambda: edges.build_edge_table(scene, native=False))
    b_nat, b_nat_s = timed(lambda: native.build_bvh_native(scene))
    b_py, b_py_s = timed(lambda: renderer._cached_bvh(scene))
    edges_equal = all(np.array_equal(getattr(e_nat, f), getattr(e_py, f)) for f in ("tri1", "corner", "tri2", "two_sided"))
    bvh_equal = all(torch.equal(getattr(b_nat, f), getattr(b_py, f))
                    for f in ("box_lo", "box_hi", "first", "count", "miss", "tri_order"))
    row = {"triangles": scene.num_triangles, "edges": e_nat.num_edges, "bvh_nodes": b_nat.num_nodes,
           "edge_table_native_s": e_nat_s, "edge_table_python_s": e_py_s, "bvh_native_s": b_nat_s,
           "bvh_python_s": b_py_s, "edge_tables_equal": edges_equal, "bvhs_equal": bvh_equal,
           "edge_table_python_s_pr8": 6.25}
    print(f"host builders, config6 stand-in (bar: native arrays equal the Python builders'): {json.dumps(row)}",
          flush=True)
    if not (edges_equal and bvh_equal):
        raise AssertionError(f"native and Python builders disagree: {row}")
    return row


def phase_bvh_frame(label: str, scene, camera, settings, frames: int = 3, profiled: bool = True) -> dict:
    """The bvh route (render_frame with intersector "bvh": the host-built
    BVH and the batched traversal, no kernel): launches of one frame (the
    counts set to 0 just before it; none expected), a finite image within
    the image bar of the kernel route's image with the same seed, the
    median frame time of each route over ``frames`` frames in turns, and,
    if ``profiled``, one profiled bvh frame at spp 1 (device busy and idle
    share; the traversal's ~50,000 small launches a sample make the
    profiler's own bookkeeping cost tens of seconds at full spp)."""
    device = scene.v0.device
    st = dataclasses.replace(settings, intersector="bvh")
    _reset_launches()
    img = render_frame(scene, camera, st)
    _sync(device)
    launches = _launch_counts()
    row = image_diff(img, render_frame(scene, camera, settings))
    times = {"bvh": [], "kernels": []}
    for i in range(frames):
        for name, s_ in (("kernels", settings), ("bvh", st)):
            _sync(device)
            t0 = time.perf_counter()
            float(render_frame(scene, camera, s_, seed=1000 + i).sum())
            times[name].append(time.perf_counter() - t0)
    bvh = renderer._cached_bvh(scene)
    frame_s, kernel_s = statistics.median(times["bvh"]), statistics.median(times["kernels"])
    rays = settings.width * settings.height * settings.spp * settings.bounces
    row.update(launches=launches, bvh_nodes=bvh.num_nodes, leaf_size=bvh.leaf_size, frame_s=frame_s,
               frame_s_all=times["bvh"], rays_per_s=rays / frame_s, kernel_frame_s=kernel_s,
               kernel_frame_s_all=times["kernels"], bvh_over_kernels=frame_s / kernel_s,
               image_mean=img.mean().item())
    if profiled:
        row.update(profile_spp=1, profile=profile_frame(
            lambda: float(render_frame(scene, camera, dataclasses.replace(st, spp=1), seed=999).sum())))
    expect = expect_launches()
    print(f"bvh frame, {label} {settings.width}x{settings.height} spp {settings.spp} bounces {settings.bounces} "
          f"(bar: the image bar against the kernel route; launches {expect}): {json.dumps(row)}", flush=True)
    if not meets_image_bar(row) or launches != expect:
        raise AssertionError(f"bvh frame {label}: {row}")
    return row


DIST_WORLD = 2
DIST_JOIN_TIMEOUT_S = 600


def _dist_expect(settings, n_scene: int, strategy: str, streamed: bool = False) -> dict:
    """Per-rank launches of one distributed frame: every closest-hit call is
    one search of the rank's shard (n_scene of them under "ring"); with one
    scene shard the renderer's packs run as in a single process (with NEE,
    K2 on the scan bounces' shadow rays). NEE is driven on one shard only."""
    if settings.estimator == "naive":
        k1, k2 = settings.spp * settings.bounces, 0
    else:
        assert n_scene == 1, "the distributed NEE phase runs on one scene shard"
        k1, k2 = settings.spp * (settings.bounces + 1), settings.spp * (settings.bounces - 1)
    k1 *= n_scene if strategy == "ring" else 1
    if streamed:
        return expect_launches(closest_hit_streamed=k1, occluded_streamed=k2)
    return expect_launches(closest_hit=k1, occluded=k2)


def _dist_frame(scene, camera, settings, mesh, strategy: str, ref, expect: dict, frames: int = 3,
                plain_check: bool = False) -> dict:
    """One distributed frame on this rank: launches (counts set to 0 just
    before it), the image against the single-process frame (the image bar
    and the count of differing pixels), and the median of ``frames``
    frames with varied seeds, the ranks started together. With
    ``plain_check`` the same distributed frame is rendered again through
    the plain versions (intersector "plucker"), so the kernels are held to
    them on this rank's own rays: ``plain_pixels_differ`` must be 0."""
    import torch.distributed as dist

    device = scene.v0.device
    dist.barrier()
    _reset_launches()
    img = render_frame_distributed(scene, camera, settings, mesh, scene_strategy=strategy, device=device)
    _sync(device)
    row = {"launches": _launch_counts(), "expected_launches": expect, **image_diff(img, ref)}
    if plain_check:
        plain = render_frame_distributed(scene, camera, dataclasses.replace(settings, intersector="plucker"), mesh,
                                         scene_strategy=strategy, device=device)
        row["plain_pixels_differ"] = int((img != plain).any(dim=-1).sum())
    times = []
    for i in range(frames):
        dist.barrier()
        t0 = time.perf_counter()
        float(render_frame_distributed(scene, camera, settings, mesh, seed=1000 + i, scene_strategy=strategy,
                                       device=device).sum())
        times.append(time.perf_counter() - t0)
    row.update(frame_s=statistics.median(times), frame_s_all=times)
    return row


def dist_worker(rank: int, world: int, tmp: str, paths: dict, device_name: str) -> None:
    """One rank of the distributed phases, two ranks on the one card under
    gloo: the config 3 stand-in at full width on meshes 2x1 and 1x2 under
    each strategy, the config 6 stand-in streamed on 1x2 (allgather), the
    config 8 stand-in's NEE on 2x1, and one 2x1 fwd+bwd of the bench loss.
    Each frame is held against the single-process frame that the parent
    saved in ``tmp``; the rows go to ``tmp/rank<r>.json``. ``paths`` maps
    "config3", "config6" and "config8" to their scene files."""
    import torch.distributed as dist

    from gpupathtracer_tpu_torch.parallel.mesh import make_mesh
    from gpupathtracer_tpu_torch.parallel.multihost import init_distributed

    device = torch.device(device_name)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host's cores
    init_distributed(init_method=f"file://{tmp}/store", world_size=world, rank=rank, backend="gloo", device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = torch.load(os.path.join(tmp, "refs.pt"), map_location=device)
    rows = {}
    scene, camera, settings = load_scene_file(paths["config3"], device=device)
    settings = dataclasses.replace(settings, spp=4)
    for n_data, n_scene in ((2, 1), (1, 2)):
        mesh = make_mesh(n_data, n_scene)
        for strategy in STRATEGIES:
            rows[f"config3 naive {n_data}x{n_scene} {strategy}"] = _dist_frame(
                scene, camera, settings, mesh, strategy, refs["config3"], _dist_expect(settings, n_scene, strategy),
                plain_check=(n_data, n_scene, strategy) == (2, 1, "allgather"))
    scene, camera, settings = load_scene_file(paths["config6"], device=device)
    settings = dataclasses.replace(settings, spp=2)
    rows["config6 streamed naive 1x2 allgather"] = _dist_frame(
        scene, camera, settings, make_mesh(1, 2), "allgather", refs["config6"],
        _dist_expect(settings, 2, "allgather", streamed=True))
    del scene
    scene, camera, settings = load_scene_file(paths["config8"], device=device)
    settings = dataclasses.replace(settings, spp=4)
    mesh = make_mesh(2, 1)
    rows["config8 nee 2x1"] = _dist_frame(scene, camera, settings, mesh, "allgather", refs["config8"],
                                          _dist_expect(settings, 1, "allgather"), plain_check=True)
    leaf, leaves = bench_leaves(scene)
    dist.barrier()
    _reset_launches()
    t0 = time.perf_counter()
    loss = render_frame_distributed(leaf, camera, settings, mesh, device=device).mean()
    grads = torch.autograd.grad(loss, leaves)
    float(grads[0].reshape(-1)[0])
    row = {"launches": _launch_counts(), "expected_launches": _dist_expect(settings, 1, "allgather"),
           "fwd_bwd_s": time.perf_counter() - t0, "loss": loss.item(), "loss_single": refs["config8_loss"].item()}
    for name, g, want in zip(("v0", "albedo"), grads, refs["config8_grads"]):
        diff = (g - want).abs()
        row[name] = {"max_abs_g": want.abs().max().item(), "max_abs_diff": diff.max().item(),
                     "outside_tolerance": int((diff > GRAD_RTOL * want.abs()
                                               + GRAD_ATOL_OF_MAX * want.abs().max()).sum()),
                     "finite": bool(torch.isfinite(g).all())}
    rows["config8 nee 2x1 fwd+bwd"] = row
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)
    dist.destroy_process_group()


def phase_distributed(device) -> dict:
    """The distributed renderer on the one card: two processes under gloo
    (NCCL refuses two ranks on one card), each frame against the
    single-process frame of this process (exact, else the image bar with
    the count of differing pixels), launches per rank as _dist_expect
    says, frame times per rank; the 2x1 gradient within GRAD_RTOL of the
    single-process one. Every process started here is joined or killed."""
    paths = {"config3": SCENE, "config6": STREAM_SCENE, "config8": NEE_SCENE}
    with tempfile.TemporaryDirectory() as tmp:
        refs = {}
        for key, spp in (("config3", 4), ("config6", 2), ("config8", 4)):
            scene, camera, settings = load_scene_file(paths[key], device=device)
            settings = dataclasses.replace(settings, spp=spp)
            refs[key] = render_frame(scene, camera, settings)
            if key == "config8":
                leaf, leaves = bench_leaves(scene)
                loss, grads = bench_loss_grads(leaf, leaves, camera, settings)
                refs["config8_loss"], refs["config8_grads"] = loss.detach(), [g.detach() for g in grads]
        torch.save(refs, os.path.join(tmp, "refs.pt"))
        del refs, scene
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(dist_worker, args=(DIST_WORLD, tmp, paths, str(device)),
                                                    nprocs=DIST_WORLD, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1):
                if time.perf_counter() - t0 > DIST_JOIN_TIMEOUT_S:
                    raise TimeoutError(f"distributed ranks still running after {DIST_JOIN_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(DIST_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    out = {}
    for label in ranks[0]:
        row = {"launches": ranks[0][label]["launches"], "by_rank": [rk[label] for rk in ranks]}
        out[label] = row
        ok = all(rk[label]["launches"] == rk[label]["expected_launches"] for rk in ranks)
        if "fwd+bwd" in label:
            ok = ok and all(rk[label][n]["outside_tolerance"] == 0 and rk[label][n]["finite"]
                            for rk in ranks for n in ("v0", "albedo"))
            bar = f"launches as expected; gradients outside_tolerance = 0 at rtol {GRAD_RTOL}, atol {GRAD_ATOL_OF_MAX}*max|g|"
        else:
            ok = ok and all(meets_image_bar(rk[label]) and rk[label].get("plain_pixels_differ", 0) == 0 for rk in ranks)
            bar = "launches as expected; exact (pixels_differ = 0) or the image bar against the single-process frame"
            bar += "; plain_pixels_differ = 0 against the plain versions" if "plain_pixels_differ" in ranks[0][label] else ""
        print(f"distributed, {label}, {DIST_WORLD} ranks on one card, gloo (bar: {bar}): {json.dumps(row)}", flush=True)
        if not ok:
            raise AssertionError(f"distributed {label}: {row}")
    print(f"distributed: {DIST_WORLD} processes, wall {wall:.1f} s with their start", flush=True)
    return out


PIPE_WORLD = 4
PIPE_MICROBATCHES = 4
PIPE_JOIN_TIMEOUT_S = 600
# (label, scene, settings changes): 4 bounces for the 4 stages; config 8 and
# config 6 with NEE, so that K2 and K4 answer the later stages' shadow rays.
PIPE_CASES = (
    ("config3 naive", "config3", {"spp": 4}),
    ("config8 nee", "config8", {"spp": 4, "bounces": 4}),
    ("config6 streamed nee", "config6", {"spp": 1, "bounces": 4, "estimator": "nee"}),
)


def _pipe_expect(settings, stage: int, streamed: bool) -> dict:
    """Launches on pipe stage ``stage`` in one pipelined frame: the stage
    applies its bounce once for each microbatch of each sample and skips
    the steps where it holds none. Bounce 0 searches the closest hit, and
    with NEE its shadow rays by a thresholded closest hit; a later bounce
    searches the closest hit on the second pack, and with NEE its shadow
    rays by the any-hit search."""
    calls = settings.spp * PIPE_MICROBATCHES
    nee = settings.estimator != "naive"
    closest, anyhit = (calls * (1 + nee), 0) if stage == 0 else (calls, calls * nee)
    if streamed:
        return expect_launches(closest_hit_streamed=closest, occluded_streamed=anyhit)
    return expect_launches(closest_hit=closest, occluded=anyhit)


def pipe_worker(rank: int, world: int, tmp: str, paths: dict, device_name: str) -> None:
    """One pipe stage of the staged-wavefront phase, four ranks on the one
    card under gloo: each case of PIPE_CASES rendered once through
    render_frame_pipelined (launches counted from 0 just before it, the
    host seconds inside ``shift``) and held against the single-process
    frames that the parent saved in ``tmp`` (through the kernels and through
    the plain versions), then timed once more with another seed. Rows go to
    ``tmp/rank<r>.json``."""
    import torch.distributed as dist

    from gpupathtracer_tpu_torch.parallel import pipeline
    from gpupathtracer_tpu_torch.parallel.multihost import init_distributed

    device = torch.device(device_name)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host's cores
    init_distributed(init_method=f"file://{tmp}/store", world_size=world, rank=rank, backend="gloo", device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shift_s = [0.0]
    untimed_shift = pipeline.shift

    def timed_shift(xs, group=None):
        t0 = time.perf_counter()
        out = untimed_shift(xs, group)
        shift_s[0] += time.perf_counter() - t0
        return out

    pipeline.shift = timed_shift
    mesh = pipeline.make_pipe_mesh(world)
    refs = torch.load(os.path.join(tmp, "refs.pt"), map_location=device)
    rows = {}
    for label, key, change in PIPE_CASES:
        scene, camera, settings = load_scene_file(paths[key], device=device)
        settings = dataclasses.replace(settings, **change)
        dist.barrier()
        _reset_launches()
        shift_s[0] = 0.0
        t0 = time.perf_counter()
        img = pipeline.render_frame_pipelined(scene, camera, settings, mesh, microbatches=PIPE_MICROBATCHES,
                                              device=device)
        _sync(device)
        row = {"launches": _launch_counts(), "expected_launches": _pipe_expect(settings, rank, key == "config6"),
               "first_frame_s": time.perf_counter() - t0, "shift_host_s": shift_s[0],
               **image_diff(img, refs[label]),
               "plain_pixels_differ": int((img != refs[f"{label} plain"]).any(dim=-1).sum())}
        dist.barrier()
        shift_s[0] = 0.0
        t0 = time.perf_counter()
        float(pipeline.render_frame_pipelined(scene, camera, settings, mesh, seed=1000,
                                              microbatches=PIPE_MICROBATCHES, device=device).sum())
        row.update(frame_s=time.perf_counter() - t0, frame_shift_host_s=shift_s[0])
        rows[label] = row
        del scene, img
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)
    dist.destroy_process_group()


def phase_pipeline(device) -> dict:
    """The staged wavefront (parallel/pipeline.py) on the one card: four
    processes under gloo, one a stage, each case of PIPE_CASES (4 bounces on
    4 stages, 4 microbatches) against this process's render_frame at the
    same settings through the kernels and through the plain versions
    (0 differing pixels against each), the launches of each kernel per
    stage as _pipe_expect says, and per rank the frame seconds and the host
    seconds inside shift (which wait for the neighbours and, through the
    staging copy, for the stage's own work). Every process started here is
    joined or killed."""
    paths = {"config3": SCENE, "config6": STREAM_SCENE, "config8": NEE_SCENE}
    with tempfile.TemporaryDirectory() as tmp:
        refs, ref_s = {}, {}
        for label, key, change in PIPE_CASES:
            scene, camera, settings = load_scene_file(paths[key], device=device)
            settings = dataclasses.replace(settings, **change)
            t0 = time.perf_counter()
            refs[label] = render_frame(scene, camera, settings)
            _sync(device)
            ref_s[label] = time.perf_counter() - t0
            refs[f"{label} plain"] = render_frame(scene, camera, dataclasses.replace(settings, intersector="plucker"))
        torch.save(refs, os.path.join(tmp, "refs.pt"))
        del refs, scene
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(pipe_worker, args=(PIPE_WORLD, tmp, paths, str(device)),
                                                    nprocs=PIPE_WORLD, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1):
                if time.perf_counter() - t0 > PIPE_JOIN_TIMEOUT_S:
                    raise TimeoutError(f"pipe stages still running after {PIPE_JOIN_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(PIPE_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    out = {}
    for label, _, _ in PIPE_CASES:
        by_rank = [rk[label] for rk in ranks]
        total = {name: sum(rk["launches"][name] for rk in by_rank) for name in KERNELS}
        row = {"launches": total, "single_process_first_frame_s": ref_s[label], "by_rank": by_rank}
        out[label] = row
        ok = all(rk["launches"] == rk["expected_launches"] and rk["pixels_differ"] == 0 and rk["finite"]
                 and rk["plain_pixels_differ"] == 0 for rk in by_rank)
        print(f"pipeline, {label}, {PIPE_WORLD} stages x {PIPE_MICROBATCHES} microbatches on one card, gloo "
              f"(bar: launches per stage as expected, pixels_differ = 0 against render_frame and "
              f"plain_pixels_differ = 0 against its plain versions; launches = the sum of the stages): "
              f"{json.dumps(row)}", flush=True)
        if not ok:
            raise AssertionError(f"pipeline {label}: {row}")
    print(f"pipeline: {PIPE_WORLD} processes, wall {wall:.1f} s with their start", flush=True)
    return out


def phase_bench(device) -> dict:
    """The port's bench (gpupathtracer_tpu_torch/bench.py) in process: the
    CLI's benchmark verb without --full on the config 3 stand-in (the
    headline and the spec-spp frame), whose last line must be the whole
    result with value > 0, the scene run named and no fwd_bwd row, with its
    K1 launches against the count its frames need and no detail file
    written; then the fwd+bwd row (``bench._bench_backward`` on the same
    scene at the verb's spp) with its own launch bar; then _bench_kernel
    once (its 24 K1 launches: three ray sets at "highest" and at "mixed",
    each a warm-up and 3 timed calls), and K1 against its plain version on
    _bench_kernel's pack and rays: the coherent and the incoherent rays
    exactly, and the incoherent rays behind the origin-key sort
    (``sorted_hit_check``)."""
    scene, camera, settings = load_scene_file(SCENE, device=device)
    warmup, iters, spp, chunk = 1, 3, 4, 32
    # (warm-up + timed) forward frames, then the spec-spp chunks.
    expect = expect_launches(closest_hit=(warmup + iters) * spp * settings.bounces
                             + (chunk + settings.spp) * settings.bounces)
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        detail_path, bench.DETAIL_PATH = bench.DETAIL_PATH, os.path.join(tmp, "BENCH_DETAIL_torch.json")
        try:
            _reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["benchmark", "--scene", SCENE, "--warmup", str(warmup), "--iters", str(iters)])
            verb_s = time.perf_counter() - t0
            launches = _launch_counts()
            detail_written = os.path.exists(bench.DETAIL_PATH)
        finally:
            bench.DETAIL_PATH = detail_path
    lines = buf.getvalue().strip().splitlines()
    result = json.loads(lines[-1])
    print(lines[-1], flush=True)
    # The fwd+bwd row, which only --full runs in the verb.
    fwd_bwd_expect = expect_launches(closest_hit=(warmup + iters) * spp * settings.bounces)
    _reset_launches()
    t0 = time.perf_counter()
    fwd_bwd = bench._bench_backward(scene, camera, dataclasses.replace(settings, spp=spp), iters, warmup, device)
    fwd_bwd_s = time.perf_counter() - t0
    fwd_bwd_launches = _launch_counts()
    _reset_launches()
    t0 = time.perf_counter()
    kernel = bench._bench_kernel(iters=iters)
    kernel_s = time.perf_counter() - t0
    kernel_launches = _launch_counts()
    print(json.dumps(kernel), flush=True)
    # The checks launch K1 after the path's counts were read.
    packed_k, (o_c, d_c), (o_i, d_i) = bench.kernel_inputs(device)
    checks = {
        "coherent": phase_kernel_check("bench kernel, coherent rays", o_c, d_c, packed_k,
                                       plain_reps=PLAIN_REPS_UNREPORTED),
        "incoherent": phase_kernel_check("bench kernel, incoherent rays", o_i, d_i, packed_k,
                                         plain_reps=PLAIN_REPS_UNREPORTED),
        "incoherent sorted": sorted_hit_check("bench kernel, incoherent rays", o_i, d_i, packed_k),
    }
    row = {"rc": rc, "verb_s": verb_s, "launches": launches, "expected_launches": expect,
           "first_line_parses": json.loads(lines[0])["value"] == result["value"],
           "detail_written": detail_written, "value": result["value"], "full_spp": result.get("full_spp"),
           "device": result.get("device"),
           "fwd_bwd": {**fwd_bwd, "call_s": fwd_bwd_s, "launches": fwd_bwd_launches,
                       "expected_launches": fwd_bwd_expect},
           "kernel_s": kernel_s, "kernel_launches": kernel_launches,
           "kernel_checks": {k: {f: r[f] for f in ("same_tri", "same_row", "max_abs_err", "t_equal") if f in r}
                             for k, r in checks.items()}}
    print(f"bench, the benchmark verb without --full on {os.path.basename(SCENE)}, its fwd+bwd row and "
          f"_bench_kernel (bar: rc 0, the last line the whole result with value > 0, config naming the scene and "
          f"no fwd_bwd row, no detail file, launches as expected, fwd+bwd rays/s > 0, K1 on _bench_kernel's "
          f"inputs as its plain version: exact unsorted and behind the sort): {json.dumps(row)}", flush=True)
    ok = (rc == 0 and result["value"] > 0 and result["config"] == os.path.basename(SCENE) and launches == expect
          and "fwd_bwd" not in result and not detail_written and row["first_line_parses"]
          and fwd_bwd["rays_per_sec"] > 0 and fwd_bwd_launches == fwd_bwd_expect
          and kernel_launches == expect_launches(closest_hit=6 * (1 + iters)))
    if not ok:
        raise AssertionError(f"bench: {result} {row}")
    return {"verb": row, "fwd_bwd": row["fwd_bwd"], "kernel": {"launches": kernel_launches, **kernel}}


def sorted_hit_check(label: str, o, d, packed) -> dict:
    """K1 behind ``make_sorted_intersect`` with the origin key, as
    ``_bench_kernel`` calls it, against the same wrapper around the plain
    version (bar: the same triangle and a bit-equal t on every ray), and
    against the plain search without the sort (bar: the hit parity bar,
    since the sort regroups the tiles and so may pick another triangle at
    an equal t)."""
    search = lambda plain: packed_intersect.make_sorted_intersect(
        lambda o, d, alive=None: packed_intersect.intersect_packed(o, d, packed, alive=alive, plain=plain),
        packed, key_mode="origin")
    h_k, h_p = search(False)(o, d), search(True)(o, d)
    h_u = packed_intersect.intersect_packed(o, d, packed, plain=True)
    _sync(o.device)
    both = h_k.hit & h_u.hit & (h_k.tri == h_u.tri)
    err_u = (h_k.t[both] - h_u.t[both]).abs()
    row = {
        "rays": o.shape[0], "hit_share": h_p.hit.double().mean().item(),
        "same_tri": (h_k.tri == h_p.tri).double().mean().item(), "t_equal": bool(torch.equal(h_k.t, h_p.t)),
        "max_abs_err": (h_k.t - h_p.t)[h_p.hit].abs().max().item() if bool(h_p.hit.any()) else 0.0,
        "same_tri_unsorted": (h_k.tri == h_u.tri).double().mean().item(),
        "max_abs_err_unsorted": err_u.max().item() if err_u.numel() else 0.0,
        "t_ok_unsorted": bool((err_u <= T_TOL + T_TOL * h_u.t[both].abs()).all()),
    }
    print(f"closest_hit {label}, behind the origin-key sort (bar: same_tri = 1 and t_equal against the sorted plain "
          f"version; same_tri_unsorted >= {HIT_AGREE}, |dt| <= {T_TOL} + {T_TOL}|t| against the unsorted plain "
          f"search): {json.dumps(row)}", flush=True)
    if not (row["same_tri"] == 1.0 and row["t_equal"] and row["same_tri_unsorted"] >= HIT_AGREE
            and row["t_ok_unsorted"]):
        raise AssertionError(f"closest_hit {label} behind the sort: {row}")
    return row


def precision_checks(name: str, label: str, kernel, plain, args, packed=None, highest_ms: float | None = None) -> dict:
    """Phase 44 on one kernel's main-path inputs ``args``: the kernel under
    each bf16 mode against its plain version at that mode (the plain
    version timed once), and against the kernel's own "highest" result by
    the JAX package's near-parity bar (``NEAR_AGREE``; "default" reported
    only). Every kernel runs the bf16 modes on the tensor cores, whose sums
    take their own order: the closest hits (K1, K3; ``packed`` given) meet
    the hit bar against the plain version, and at "mixed" (t in f32 as
    "highest") t bit-equal wherever the triangle agrees; the any hits (K2,
    K4; ``packed`` None) the flag bar. Prints ms, x highest (``highest_ms``:
    the "highest" check's time on the same inputs), the bound and its
    share, and the instantiation's registers, CTAs per SM, HMMA and FFMA
    instructions."""
    base = kernel(*args)
    lib = os.path.basename(KERNELS[name]["source"]).removesuffix(".cu")
    rows = {}
    for mode in PRECISION_MODES:
        k, p = partial(kernel, precision=mode), partial(plain, precision=mode)
        flop = FLOP_PER_PAIR_AT[mode]
        if packed is not None:
            row = hit_check(name, f"{label} at {mode}", k, p, args, packed, t_exact=mode == "mixed", plain_reps=0,
                            flop_per_pair=flop)
            bt0, bi0 = base
            bt, bi = k(*args)
            tri = lambda bi: torch.where(bi >= 0, packed.tri_map[bi.long().clamp(min=0)], -1)
            agree = tri(bi) == tri(bi0)
            same = agree & (bi0 >= 0)
            dt = (bt[same] - bt0[same]).abs()
            near = {"same_tri_vs_highest": agree.double().mean().item(),
                    "max_abs_dt_vs_highest": dt.max().item() if dt.numel() else 0.0,
                    "t_equal_vs_highest": bool(torch.equal(bt[same], bt0[same])),
                    "t_ok_vs_highest": bool((dt <= NEAR_T_TOL + NEAR_T_TOL * bt0[same].abs()).all())}
            held = near["same_tri_vs_highest"] > NEAR_AGREE and (
                near["t_equal_vs_highest"] if mode == "mixed" else near["t_ok_vs_highest"])
        else:
            row = occlusion_check(name, f"{label} at {mode}", k, p, args, plain_reps=0, flop_per_pair=flop)
            near = {"same_flag_vs_highest": (k(*args) == base).double().mean().item()}
            held = near["same_flag_vs_highest"] > NEAR_AGREE
        _sync(args[0].device)
        occ = OCCUPANCY_ROWS[(lib, mode, False)]
        row.update(near, precision=mode, ptxas=occ["ptxas"], ctas_per_sm=occ["ctas_per_sm"], threads=occ["threads"],
                   route=occ["route"], hmma=occ.get("hmma"), ffma=occ.get("ffma"),
                   over_highest=row["ms"] / highest_ms if highest_ms else None, share=row["bound_ms"] / row["ms"])
        bar = ("none (diagnostics only, as in the JAX package)" if mode == "default" else
               f"same triangle or flag > {NEAR_AGREE}" + ("" if packed is None else
                                                          ", t bit-equal" if mode == "mixed" else f", |dt| <= {NEAR_T_TOL}"))
        shown = ("ms", "over_highest", "bound_ms", "bound_by", "share", "route", "ptxas", "ctas_per_sm", "threads",
                 "hmma", "ffma")
        print(f"precision {name} {label} at {mode} against highest (bar: {bar}): "
              f"{json.dumps({**near, **{key: row[key] for key in shown}})}", flush=True)
        if mode != "default" and not held:
            raise AssertionError(f"{name} {label} at {mode} misses the near-parity bar against highest: {near}")
        rows[mode] = row
    return rows


def phase_precision_frames(device) -> dict:
    """Phase 44's paths: for each bf16 mode, the config 3 stand-in's naive
    frame (800x800, spp 4, 4 bounces; K1), the config 8 stand-in's NEE frame
    (512x512, spp 4, 3 bounces; K1, K2) and the config 6 stand-in's streamed
    NEE frame (800x800, spp 1, 3 bounces; K3, K4) with kernel_precision
    set: launches (counts set to 0 just before each frame), the median of 3
    frame times, and the image against the "highest" frame of the same
    seed, held to the image bar ("default" reported only). Then the bench's
    precision ladder rows on the config 3 stand-in."""
    cases = [
        ("config3 naive", SCENE, {"spp": 4}, lambda st: expect_launches(closest_hit=st.spp * st.bounces)),
        ("config8 nee", NEE_SCENE, {"spp": 4},
         lambda st: expect_launches(closest_hit=st.spp * (st.bounces + 1), occluded=st.spp * (st.bounces - 1))),
        ("config6 streamed nee", STREAM_SCENE, {"spp": 1, "bounces": 3, "estimator": "nee"},
         lambda st: expect_launches(closest_hit_streamed=st.spp * (st.bounces + 1),
                                    occluded_streamed=st.spp * (st.bounces - 1))),
    ]
    out = {mode: {} for mode in PRECISION_MODES}
    for label, path, change, expect in cases:
        scene, camera, settings = load_scene_file(path, device=device)
        settings = dataclasses.replace(settings, **change)
        ref = render_frame(scene, camera, settings)
        highest_s = phase_full_frame(f"{label}, kernel_precision highest", scene, camera, settings,
                                     expect(settings))["frame_s"]
        for mode in PRECISION_MODES:
            st = dataclasses.replace(settings, kernel_precision=mode)
            row = phase_full_frame(f"{label}, kernel_precision {mode}", scene, camera, st, expect(st))
            row.update(image_diff(render_frame(scene, camera, st), ref), highest_frame_s=highest_s,
                       over_highest=row["frame_s"] / highest_s)
            print(f"precision frame {label} at {mode} against highest (bar: "
                  f"{'none' if mode == 'default' else f'mean|diff| < {IMG_MEAN}, off share < {IMG_OFF_SHARE}'}): "
                  f"{json.dumps({k: row[k] for k in ('mean_abs_diff', 'off_share', 'pixels_differ', 'frame_s', 'over_highest')})}",
                  flush=True)
            if mode != "default" and not meets_image_bar(row):
                raise AssertionError(f"{label} at {mode} misses the image bar against highest: {row}")
            out[mode][label] = row
        del scene, ref
    scene, camera, settings = load_scene_file(SCENE, device=device)
    settings = dataclasses.replace(settings, spp=4)
    ladder = {}
    for key, precision in bench.PRECISION_LADDER:
        _reset_launches()
        ladder[key] = bench._bench_frame(scene, camera, dataclasses.replace(settings, kernel_precision=precision),
                                         iters=3, device=device)
        ladder[key]["launches"] = _launch_counts()
    print(f"bench precision ladder on {os.path.basename(SCENE)} (bar: rays/s > 0, K1 launches of 4 frames): "
          f"{json.dumps(ladder)}", flush=True)
    want = expect_launches(closest_hit=4 * settings.spp * settings.bounces)
    if any(r["rays_per_sec"] <= 0 or r["launches"] != want for r in ladder.values()):
        raise AssertionError(f"bench precision ladder: {ladder}")
    return {"frames": out, "ladder": ladder}


# (budget, subtiles, fresh): the JAX package's cases (tests/test_stream_modes.py).
STREAM_MODE_CASES = ((1, 1, False), (2, 1, False), (0, 2, False), (0, 4, False), (2, 4, False), (0, 1, True),
                     (2, 1, True))


@contextlib.contextmanager
def stream_modes(budget: int = 0, subtiles: int = 1, fresh: bool = False):
    """The streamed closest hit's traversal-mode constants set for a block."""
    names = ("STREAM_PHASE1_BUDGET", "STREAM_SUBTILES", "STREAM_FRESH_WORST")
    saved = [getattr(packed_intersect, n) for n in names]
    for n, v in zip(names, (budget, subtiles, fresh)):
        setattr(packed_intersect, n, v)
    try:
        yield
    finally:
        for n, v in zip(names, saved):
            setattr(packed_intersect, n, v)


def phase_stream_modes(rays) -> dict:
    """Phase 45, K3's traversal modes on the config 6 stand-in's camera and
    bounce-1 rays (``rays``: (label, o, d, packed)): each case of
    ``STREAM_MODE_CASES`` through intersect_packed gives t, tri and hit
    bit-identical to the single-phase search, with its K3 launches (counts
    set to 0 just before, 2 with a budget) and its median time of 5 against
    the single-phase one's; one case at "mixed" against single-phase at
    "mixed"; then the budgeted search (budget 1) on the bounce-1 rays:
    kernel against plain version exactly (rows, t and done flags), and
    every live lane it reports done holds its single-phase triangle, with
    some lanes left undone."""
    out = {"cases": [], "launches": 0}
    for label, o, d, packed in rays:
        device = o.device
        search = lambda precision="highest": packed_intersect.intersect_packed(o, d, packed, precision=precision)
        ref = search()
        single_ms = median_ms(search, device)
        for budget, subtiles, fresh in STREAM_MODE_CASES:
            with stream_modes(budget, subtiles, fresh):
                _reset_launches()
                h = search()
                _sync(device)
                launches = _launch_counts()
                ms = median_ms(search, device)
            want = expect_launches(closest_hit_streamed=2 if budget else 1)
            row = {"rays": label, "budget": budget, "subtiles": subtiles, "fresh": fresh,
                   "identical": all(torch.equal(getattr(h, f), getattr(ref, f)) for f in ("t", "tri", "hit")),
                   "launches": launches, "ms": ms, "single_phase_ms": single_ms, "over_single": ms / single_ms}
            print(f"stream modes {label} (bar: t, tri, hit bit-identical to single-phase; launches {want}): "
                  f"{json.dumps(row)}", flush=True)
            if not row["identical"] or launches != want:
                raise AssertionError(f"stream modes {label}: {row}")
            out["cases"].append(row)
            out["launches"] += launches["closest_hit_streamed"]
        with stream_modes(2, 4, False):
            h = search("mixed")
        ref_mixed = search("mixed")
        _sync(device)
        if not all(torch.equal(getattr(h, f), getattr(ref_mixed, f)) for f in ("t", "tri", "hit")):
            raise AssertionError(f"stream modes {label}: budget 2, subtiles 4 at mixed differs from single-phase")
        print(f"stream modes {label}: budget 2, subtiles 4 at mixed bit-identical to single-phase at mixed", flush=True)
    label, o, d, packed = rays[-1]
    args = prepare_rays_streamed(o, d, packed) + (STREAM_RAY_TILE,)
    kernel = partial(closest_hit_streamed, budget=1, with_done=True)
    plain = partial(closest_hit_streamed_reference, budget=1, with_done=True)
    bt, bi, done = kernel(*args)
    _sync(o.device)
    t0 = time.perf_counter()
    bt_r, bi_r, done_r, work = plain(*args, count_work=True)
    _sync(o.device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    ref = packed_intersect.intersect_packed(o, d, packed)
    r = o.shape[0]
    live = args[4] > 0
    tri = torch.where(bi >= 0, packed.tri_map[bi.long().clamp(min=0)], -1)[:r]
    done_live = ((done > 0) & live)[:r]
    b = bound(FLOP_PER_PAIR * work["lane_blocks"] * packed.tri_block, _nbytes(*args, bt, bi, done))
    row = {"rays": r, "budget": 1, "exact": bool(torch.equal(bt, bt_r) and torch.equal(bi, bi_r)
                                                 and torch.equal(done, done_r)),
           "max_abs_err": (bt - bt_r)[bi_r >= 0].abs().max().item() if bool((bi_r >= 0).any()) else 0.0,
           "done_live": int(done_live.sum()), "undone_live": int(((done == 0) & live).sum()),
           "done_sound": bool(torch.equal(tri[done_live], ref.tri[done_live])),
           "ms": median_ms(lambda: kernel(*args), o.device), "plain_ms": plain_ms,
           "visited_blocks": work["blocks"], "lane_blocks": work["lane_blocks"], **b}
    print(f"stream modes {label}, budget 1 with done flags (bar: kernel = plain exactly, done lanes hold their "
          f"single-phase triangle, some live lanes undone): {json.dumps(row)}", flush=True)
    if not (row["exact"] and row["done_sound"] and row["undone_live"] > 0):
        raise AssertionError(f"stream modes, budget 1: {row}")
    out["done_check"] = row
    # The same budgeted search at "mixed", where K3's modes kernel runs on
    # the tensor cores: the hit bar against its plain version, t bit-equal
    # where the triangle agrees.
    mixed = hit_check("closest_hit_streamed", f"{label}, budget 1 at mixed",
                      partial(closest_hit_streamed, budget=1, precision="mixed"),
                      partial(closest_hit_streamed_reference, budget=1, precision="mixed"), args, packed,
                      t_exact=True, plain_reps=0, flop_per_pair=FLOP_PER_PAIR_AT["mixed"])
    bt, bi, done = closest_hit_streamed(*args, budget=1, with_done=True, precision="mixed")
    _, bi_r, done_r = closest_hit_streamed_reference(*args, budget=1, with_done=True, precision="mixed")
    mixed["same_done"] = (done == done_r).double().mean().item()
    mixed["undone_live"] = int(((done == 0) & live).sum())
    print(f"stream modes {label}, budget 1 at mixed with done flags (bar: the hit bar, t bit-equal where the "
          f"triangle agrees; some live lanes undone): {json.dumps({k: mixed[k] for k in ('same_tri', 'max_abs_err', 't_equal_same_tri', 'same_done', 'undone_live', 'ms', 'plain_ms', 'bound_ms')})}",
          flush=True)
    if mixed["undone_live"] == 0:
        raise AssertionError(f"stream modes, budget 1 at mixed left no lane undone: {mixed}")
    out["mixed_budget_check"] = mixed
    return out


def kernel_summary(name: str, rows, launches: int, launches_by_path: dict, label: str | None = None) -> dict:
    """The summary entry of one kernel over its checks at main-path shapes."""
    b = bound(sum(r["flop"] for r in rows), sum(r["bytes"] for r in rows), sum(r["bf16_flop"] for r in rows))
    return {
        "name": label or name, "route": "cuda", "source": KERNELS[name]["source"],
        "replaces": KERNELS[name]["replaces"],
        "launches": launches, "launches_by_path": launches_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": b["bound_by"], "library_ms": None,
    }


def main() -> None:
    t_start = time.perf_counter()
    elapsed = lambda label: print(f"elapsed: {time.perf_counter() - t_start:.1f} s at {label}", flush=True)
    phase_device()
    device = torch.device("cuda")
    # The parity bars need f32 products, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    pcg_rows = phase_pcg(device)
    shade_rows = phase_shade(device)
    schedule_rows = phase_schedule(device)
    phase_native_build()

    elapsed("naive path")
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
    mode_rows = {"closest_hit": [
        precision_checks("closest_hit", label, closest_hit, closest_hit_reference,
                         prepare_rays(oo, dd, p) + (p.w, DEFAULT_RAY_TILE), p, row["ms"])
        for (label, oo, dd, p), row in zip((("camera rays", o, d, packed), ("bounce-1 rays", o2, d2, packed2)),
                                           k1_rows)
    ]}
    # What a rank of a 1x2 scene axis searches: the same rays against scene
    # shard 1 of 2, packed at the one width the sharded frames use.
    shard3 = pack_scene(scene_shard(scene, 2, 1), tri_block=settings.tri_block)
    k1_shard_rows = [
        phase_kernel_check("camera rays, scene shard 1 of 2", o, d, shard3, plain_reps=PLAIN_REPS_UNREPORTED),
        phase_kernel_check("bounce-1 rays, scene shard 1 of 2", o2, d2, shard3, plain_reps=PLAIN_REPS_UNREPORTED),
    ]
    del shard3
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

    elapsed("NEE path")
    # The NEE path (config 8 stand-in).
    scene, camera, settings = load_scene_file(NEE_SCENE, device=device)
    settings = dataclasses.replace(settings, spp=4)
    packed = pack_scene(scene, tri_block=settings.tri_block)
    packed2 = pack_scene(scene, tri_block=settings.tri_block_secondary)
    for p in (packed, packed2):
        phase_live_zeros(f"config8 tb {p.tri_block}", p)
    k2_args = nee_shadow_inputs(scene, camera, settings, packed, packed2, "occluded_reference")
    k2_row = occlusion_check("occluded", "bounce-1 shadow rays", occluded, occluded_reference, k2_args, exact=True)
    mode_rows["occluded"] = [precision_checks("occluded", "bounce-1 shadow rays", occluded, occluded_reference, k2_args,
                                              highest_ms=k2_row["ms"])]
    del k2_args
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
        plain_reps=PLAIN_REPS_UNREPORTED,
    )
    nee_modes = phase_compact_modes("config8 nee", scene, camera, settings, nee_expect(settings))
    del scene, packed, packed2

    elapsed("streamed path")
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
    mode_rows["closest_hit_streamed"] = [
        precision_checks("closest_hit_streamed", label, closest_hit_streamed, closest_hit_streamed_reference,
                         prepare_rays_streamed(oo, dd, p) + (STREAM_RAY_TILE,), p, row["ms"])
        for (label, oo, dd, p), row in zip((("camera rays", o, d, packed), ("bounce-1 rays", o2, d2, packed2)),
                                           k3_rows)
    ]
    elapsed("K3's traversal modes")
    k3_modes = phase_stream_modes([("camera rays", o, d, packed), ("bounce-1 rays", o2, d2, packed2)])
    shard6 = pack_scene(scene_shard(scene, 2, 1), tri_block=settings.tri_block)
    phase_live_zeros("config6 scene shard 1 of 2", shard6)
    k3_shard_rows = [
        phase_streamed_check("camera rays, scene shard 1 of 2", o, d, shard6, rows_exact=True,
                             plain_reps=PLAIN_REPS_UNREPORTED),
        phase_streamed_check("bounce-1 rays, scene shard 1 of 2", o2, d2, shard6, rows_exact=True,
                             plain_reps=PLAIN_REPS_UNREPORTED),
    ]
    del shard6
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
    k4_args = nee_shadow_inputs(scene, camera, nee_settings, packed, packed2, "occluded_streamed_reference")
    k4_row = occlusion_check("occluded_streamed", "bounce-1 shadow rays", occluded_streamed,
                             occluded_streamed_reference, k4_args)
    mode_rows["occluded_streamed"] = [precision_checks("occluded_streamed", "bounce-1 shadow rays", occluded_streamed,
                                                       occluded_streamed_reference, k4_args, highest_ms=k4_row["ms"])]
    del k4_args
    k4_mask_row = occlusion_check(
        "occluded_streamed", "bounce-1 shadow rays uncompacted, max_t = 0 on dead lanes (mask mode)",
        occluded_streamed, occluded_streamed_reference,
        nee_shadow_inputs(scene, camera, nee_settings, packed, packed2, "occluded_streamed_reference", mask_mode=True),
        exact=True, plain_reps=PLAIN_REPS_UNREPORTED,
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

    elapsed("config 5 gradients and trainer")
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

    elapsed("boundary gradient")
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

    elapsed("bvh, host builders")
    # The BVH route, the host builders and the distributed renderer.
    bvh3 = phase_bvh_frame("config3 stand-in", scene, camera, dataclasses.replace(settings, spp=4))
    elapsed("host builders")
    scene, camera, settings = load_scene_file(STREAM_SCENE, device=device)
    phase_host_builders(scene)
    elapsed("bvh config 6")
    # A diagnostic, cut from 800x800 spp 2 to 400x400 spp 1, one timed frame
    # a route and no profile: the bvh frame is some 30x the K3 frame.
    small = dataclasses.replace(settings, width=400, height=400, spp=1)
    bvh6 = phase_bvh_frame("config6 stand-in (reduced)", scene, dataclasses.replace(camera, width=400, height=400),
                           small, frames=1, profiled=False)
    del scene
    elapsed("distributed")
    distributed = phase_distributed(device)
    elapsed("pipeline")
    pipelined = phase_pipeline(device)
    elapsed("bench")
    bench_rows = phase_bench(device)
    elapsed("precision paths")
    precision = phase_precision_frames(device)
    print(json.dumps({"scene_shard_checks": {"closest_hit": k1_shard_rows, "closest_hit_streamed": k3_shard_rows}}),
          flush=True)

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
             "threefry frame": threefry_row, "bvh config3": bvh3, "bvh config6 reduced": bvh6,
             **{f"distributed {k}": v for k, v in distributed.items()},
             **{f"pipeline {k} (sum of the stages)": v for k, v in pipelined.items()},
             "bench verb": bench_rows["verb"], "bench fwd+bwd": bench_rows["fwd_bwd"],
             "bench kernel": bench_rows["kernel"]}
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
    for mode in PRECISION_MODES:
        frames = precision["frames"][mode]
        for name in KERNELS:
            by = {f"{path} at {mode}": r["launches"][name] for path, r in frames.items()}
            summary.append(kernel_summary(name, [r[mode] for r in mode_rows[name]], sum(by.values()), by,
                                          label=f"{name} ({mode})"))
    summary.append(kernel_summary(
        "closest_hit_streamed", [k3_modes["done_check"]], k3_modes["launches"],
        {"K3 traversal mode cases": k3_modes["launches"]}, label="closest_hit_streamed (budget, subtiles, fresh)"))
    summary += [{**r, "route": "cuda", "source": "gpupathtracer_tpu_torch/csrc/pcg.cu", "replaces": None,
                 "launches_by_path": dict(PCG_LAUNCHES_BY_PATH)} for r in pcg_rows]
    summary += [{**r, "route": "cuda", "source": "gpupathtracer_tpu_torch/csrc/shade.cu", "replaces": None,
                 "launches_by_path": dict(SHADE_LAUNCHES_BY_PATH)} for r in shade_rows]
    summary += [{**r, "route": "cuda", "source": "gpupathtracer_tpu_torch/csrc/schedule.cu", "replaces": None,
                 "launches_by_path": dict(SCHEDULE_LAUNCHES_BY_PATH)} for r in schedule_rows]
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
