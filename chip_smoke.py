"""Smoke run of the PyTorch + CUDA port (gpupathtracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
1. device: the card's name and power limit from nvidia-smi;
2. build: nvcc builds csrc/closest_hit.cu and csrc/occlusion.cu from this
   checkout, both started together;
3. the closest-hit kernel against its plain PyTorch version at the naive
   path's shapes: 640,000 camera rays against the tri_block-128 pack and
   640,000 bounce-1 rays (traced with the plain version, compacted as the
   render does) against the tri_block-512 pack, with the hit parity bar, the
   median time of each over 5 runs and the bound;
4. naive render_frame at 256x256, spp 2 through the kernel against the same
   render through the plain version, with the image parity bar;
5. the naive path at full size (800x800, spp 4, 4 bounces): a finite image,
   exactly spp x bounces closest-hit launches, and the median frame time and
   rays/s (rays = W*H*spp*bounces) over 3 frames with varied seeds;
6. the any-hit kernel against its plain version on the shadow rays that
   bounce 1 of the NEE path casts at 512x512 (bounce 0 traced with the plain
   version, the shadow rays compacted as the render does) against the
   tri_block-512 pack, with the flag bar, the median time of each over 5
   runs, the visited blocks and the bound;
7. NEE and MIS render_frame at 128x128, spp 2 through the kernels against
   the plain versions, with the image parity bar;
8. the NEE path at full width (512x512, spp 4, 3 bounces): a finite image,
   exactly spp x (bounces + 1) closest-hit and spp x (bounces - 1) any-hit
   launches, the median frame time and rays/s over 3 frames with varied
   seeds, and one more frame under torch.profiler split into kernel and
   other device time and the device's idle share;
then a JSON line that summarises both kernels, and a JSON result line last.

The naive path renders scenes/config3_icosphere.toml and the NEE path
scenes/config8_icosphere.toml: configs 3 and 8 with their OBJ meshes
replaced by icospheres, so the run needs no asset files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import time

import torch

from gpupathtracer_tpu_torch.models.camera import generate_rays_for_pixels
from gpupathtracer_tpu_torch.ops import _build, packed_intersect
from gpupathtracer_tpu_torch.ops.compaction import compact_rays
from gpupathtracer_tpu_torch.ops.packed_intersect import (
    DEFAULT_RAY_TILE,
    closest_hit,
    closest_hit_reference,
    occluded,
    occluded_reference,
    pack_scene,
    prepare_rays,
)
from gpupathtracer_tpu_torch.ops.plucker import NSCALARS
from gpupathtracer_tpu_torch.ops.sampling import PcgSampler, prng_key_data
from gpupathtracer_tpu_torch.render.integrator import IntegratorOptions, init_path_state, make_bounce_fn
from gpupathtracer_tpu_torch.render.renderer import narrow_settings, render_frame
from gpupathtracer_tpu_torch.utils.config import load_scene_file

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "scenes", "config3_icosphere.toml")
NEE_SCENE = os.path.join(ROOT, "scenes", "config8_icosphere.toml")
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
}
BUILD_NAMES = {"closest_hit": "closest_hit", "occluded": "occlusion"}

# The least time the card could take (H100 SXM data sheet, dense, at the
# 700 W limit): f32 outside the tensor cores, the precision the parity bar
# needs, and device memory.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Per (lane, triangle column) of a visited block: 5 decision scalars x the
# 10 nonzero feature rows x (multiply + add).
FLOP_PER_PAIR = NSCALARS * 10 * 2

# Parity bars of the reference's own on-chip tests (tests_tpu/test_onchip.py).
HIT_AGREE = 0.9995  # share of rays with the same winning triangle
T_TOL = 1e-5  # rtol = atol on t where the triangle agrees
IMG_MEAN = 2e-3  # mean |diff|
IMG_PIXEL = 3e-2  # a pixel is "off" above this max-channel |diff| ...
IMG_OFF_SHARE = 5e-3  # ... and fewer than this share may be off


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


def bound(flop: float, nbytes: float) -> dict:
    """The least time for ``flop`` f32 operations moving ``nbytes``, and
    which of the two bounds it."""
    t_ops, t_bytes = flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {
        "flop": flop, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
        textured=narrowed.textured, intersector="plucker",
    )
    state = make_bounce_fn(scene, opts, packed=packed)(init_path_state(o, d, keys), 0, compact_now=False)
    return (o, d), state, opts


def main_path_rays(scene, camera, settings, packed):
    """Sample 0's camera rays, and the rays of bounce 1 after bounce 0 was
    traced with the plain version and compacted as the scan bounces are."""
    (o, d), state, _ = sample0_bounce0(scene, camera, settings, packed)
    o2, d2, _ = compact_rays(state.o, state.d, state.alive)
    return (o, d), (o2, d2)


def nee_shadow_inputs(scene, camera, settings, packed, packed2):
    """The any-hit inputs ``(order, enter, feats, maxt, w, ray_tile)`` of the
    shadow rays that bounce 1 casts, as the render builds them (compacted,
    padded, culled and scheduled), taken from a plain-version trace."""
    _, state, opts = sample0_bounce0(scene, camera, settings, packed)
    captured = []
    plain = packed_intersect.occluded_reference

    def capture(*args):
        captured.append(args)
        return plain(*args)

    # The scan bounce looks the search up when it is built.
    packed_intersect.occluded_reference = capture
    try:
        bounce1 = make_bounce_fn(scene, opts, packed=packed2, occlusion_kernel=True)
    finally:
        packed_intersect.occluded_reference = plain
    bounce1(state, 1)
    if len(captured) != 1:
        raise AssertionError(f"bounce 1 cast {len(captured)} shadow-ray batches, expected 1")
    return captured[0]


def phase_kernel_check(label: str, o, d, packed, reps: int = 5) -> dict:
    """The kernel against closest_hit_reference on the same inputs."""
    device = o.device
    order, enter, feats, alive = prepare_rays(o, d, packed)
    args = (order, enter, feats, alive, packed.w, DEFAULT_RAY_TILE)
    bt_k, bi_k = closest_hit(*args)
    bt_r, bi_r, work = closest_hit_reference(*args, count_work=True)
    _sync(device)
    tri_map = lambda bi: torch.where(bi >= 0, packed.tri_map[bi.long().clamp(min=0)], -1)
    tri_k, tri_r = tri_map(bi_k), tri_map(bi_r)
    agree = (tri_k == tri_r).double().mean().item()
    same = (tri_k == tri_r) & (bi_r >= 0)
    err = (bt_k[same] - bt_r[same]).abs()
    max_abs_err = err.max().item() if err.numel() else 0.0
    t_ok = bool((err <= T_TOL + T_TOL * bt_r[same].abs()).all())
    kernel_ms = median_ms(lambda: closest_hit(*args), device, reps)
    plain_ms = median_ms(lambda: closest_hit_reference(*args), device, reps)
    b = bound(
        FLOP_PER_PAIR * work["lane_blocks"] * packed.tri_block,
        _nbytes(order, enter, feats, alive, packed.w, bt_k, bi_k),
    )
    row = {
        "rays": o.shape[0], "tri_block": packed.tri_block, "hit_share": (bi_r >= 0).double().mean().item(),
        "same_tri": agree, "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "visited_blocks": work["blocks"], "lane_blocks": work["lane_blocks"], **b,
    }
    print(f"closest_hit {label} (bar: same_tri >= {HIT_AGREE}, |dt| <= {T_TOL} + {T_TOL}|t|): {json.dumps(row)}", flush=True)
    if agree < HIT_AGREE or not t_ok:
        raise AssertionError(f"closest_hit {label} misses the hit parity bar: same_tri {agree}, t ok {t_ok}")
    return row


def phase_occlusion_check(args, reps: int = 5) -> dict:
    """The any-hit kernel against occluded_reference on the same inputs."""
    order, enter, feats, maxt, w, ray_tile = args
    device = feats.device
    occ_k = occluded(*args)
    occ_r, work = occluded_reference(*args, count_work=True)
    _sync(device)
    agree = (occ_k == occ_r).double().mean().item()
    dead_occluded = int((occ_k[maxt == 0] != 0).sum())
    kernel_ms = median_ms(lambda: occluded(*args), device, reps)
    plain_ms = median_ms(lambda: occluded_reference(*args), device, reps)
    tb = w.shape[2] // NSCALARS
    b = bound(FLOP_PER_PAIR * work["lane_blocks"] * tb, _nbytes(order, enter, feats, maxt, w, occ_k))
    row = {
        "rays": feats.shape[0], "live_rays": int((maxt > 0).sum()), "tri_block": tb,
        "occluded_share": (occ_r > 0).double().mean().item(), "same_flag": agree,
        "dead_lanes_occluded": dead_occluded, "max_abs_err": (occ_k - occ_r).abs().max().item(),
        "ms": kernel_ms, "plain_ms": plain_ms,
        "visited_blocks": work["blocks"], "lane_blocks": work["lane_blocks"], **b,
    }
    print(f"occluded bounce-1 shadow rays (bar: same_flag >= {HIT_AGREE}, no maxt = 0 lane occluded): "
          f"{json.dumps(row)}", flush=True)
    if agree < HIT_AGREE or dead_occluded:
        raise AssertionError(f"occluded misses the flag bar: same_flag {agree}, {dead_occluded} dead lanes occluded")
    return row


def phase_image_check(scene, camera, settings, size: int, spp: int) -> None:
    """render_frame through the kernels against render_frame through the
    plain versions."""
    cam = dataclasses.replace(camera, width=size, height=size)
    st = dataclasses.replace(settings, width=size, height=size, spp=spp)
    img_k = render_frame(scene, cam, st)
    img_r = render_frame(scene, cam, dataclasses.replace(st, intersector="plucker"))
    diff = (img_k - img_r).abs()
    mean_diff = diff.mean().item()
    off_share = (diff.amax(dim=-1) > IMG_PIXEL).double().mean().item()
    finite = bool(torch.isfinite(img_k).all())
    print(
        f"render {st.estimator} {size}x{size} spp {spp}: kernels vs plain mean|diff| {mean_diff:.3e} "
        f"(bar < {IMG_MEAN}), max|diff| {diff.max().item():.3e}, pixels off by > {IMG_PIXEL}: {off_share:.3e} "
        f"(bar < {IMG_OFF_SHARE}), image mean {img_k.mean().item():.6f}",
        flush=True,
    )
    if not finite or mean_diff >= IMG_MEAN or off_share >= IMG_OFF_SHARE:
        raise AssertionError("render misses the image parity bar")


def profile_frame(scene, camera, settings) -> dict:
    """One frame under torch.profiler: device time per kernel name, and the
    device's idle share of the frame's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = scene.v0.device
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(render_frame(scene, camera, settings, seed=999).sum())
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
    for kname in ("closest_hit_kernel", "occlusion_kernel"):
        out[f"{kname}_ms"] = sum(v for k, v in by_name.items() if kname in k)
    out["other_device_ms"] = sum(by_name.values()) - out["closest_hit_kernel_ms"] - out["occlusion_kernel_ms"]
    out["idle_share_profiled"] = 1.0 - out["device_busy_ms"] / wall_ms if spans else None
    return out


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
        out["profile"] = profile_frame(scene, camera, settings)
    shadow = " (shadow rays not counted)" if settings.estimator != "naive" else ""
    print(
        f"frame, {label} path, {settings.width}x{settings.height} spp {settings.spp} "
        f"bounces {settings.bounces}, rays = W*H*spp*bounces{shadow}: {json.dumps(out)}",
        flush=True,
    )
    return out


def main() -> None:
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
    (o, d), (o2, d2) = main_path_rays(scene, camera, settings, packed)
    rows = [
        phase_kernel_check("camera rays", o, d, packed),
        phase_kernel_check("bounce-1 rays", o2, d2, packed2),
    ]
    phase_image_check(scene, camera, settings, size=256, spp=2)
    naive = phase_full_frame(
        "naive", scene, camera, settings, {"closest_hit": settings.spp * settings.bounces, "occluded": 0}
    )

    # The NEE path (config 8 stand-in).
    scene, camera, settings = load_scene_file(NEE_SCENE, device=device)
    settings = dataclasses.replace(settings, spp=4)
    packed = pack_scene(scene, tri_block=settings.tri_block)
    packed2 = pack_scene(scene, tri_block=settings.tri_block_secondary)
    occ_row = phase_occlusion_check(nee_shadow_inputs(scene, camera, settings, packed, packed2))
    for estimator in ("nee", "mis"):
        phase_image_check(scene, camera, dataclasses.replace(settings, estimator=estimator), size=128, spp=2)
    nee = phase_full_frame(
        "nee", scene, camera, settings,
        {"closest_hit": settings.spp * (settings.bounces + 1), "occluded": settings.spp * (settings.bounces - 1)},
        profiled=True,
    )

    # closest_hit: one bounce-0 call plus one scan-bounce call of the naive
    # path, each at its main-path shape; occluded: one scan-bounce call.
    k1 = bound(sum(r["flop"] for r in rows), sum(r["bytes"] for r in rows))
    summary = [
        {
            "name": "closest_hit", "route": "cuda",
            "source": KERNELS["closest_hit"]["source"], "replaces": KERNELS["closest_hit"]["replaces"],
            "launches": nee["launches"]["closest_hit"],
            "launches_by_path": {"naive": naive["launches"]["closest_hit"], "nee": nee["launches"]["closest_hit"]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": k1["bound_by"], "library_ms": None,
        },
        {
            "name": "occluded", "route": "cuda",
            "source": KERNELS["occluded"]["source"], "replaces": KERNELS["occluded"]["replaces"],
            "launches": nee["launches"]["occluded"],
            "launches_by_path": {"naive": naive["launches"]["occluded"], "nee": nee["launches"]["occluded"]},
            "max_abs_err": occ_row["max_abs_err"], "ms": occ_row["ms"], "plain_ms": occ_row["plain_ms"],
            "bound_ms": occ_row["bound_ms"], "bound_by": occ_row["bound_by"], "library_ms": None,
        },
    ]
    print(json.dumps({"kernels": summary}), flush=True)
    result = {
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
