"""Times the kernels of the PyTorch + CUDA port under several launch shapes,
at the main paths' shapes, on one card.

    python3 tools/stream_sweep.py [resident|streamed|mma]   (resident and streamed by default)

resident: K1 and K2, with inputs built as chip_smoke.py's phases 3 and 6
build them (640,000 camera rays at tb 128 and 640,000 bounce-1 rays at tb
512 on scenes/config3_icosphere.toml; bounce 1's NEE shadow rays at tb 512
on scenes/config8_icosphere.toml; 128-ray tiles). Also builds K1 and K2
once more from a copy of csrc/ with a ring of 2 stages instead of 3, and
times that at the default launch shape.

streamed: K3 and K4, with inputs built as phases 9 and 11 build them on
scenes/config6_icosphere.toml (640,000 camera rays at tb 256, 640,000
bounce-1 rays at tb 1024, bounce 1's NEE shadow rays at tb 1024; 64-ray
tiles).

mma: K2, K4, K1 and K3 at "high", "mixed" and "default" (the tensor-core
route, LAUNCH_MMA), on the inputs above (K2's and K4's the NEE shadow rays
of phase 44); shapes are (threads a CTA aims at, m-tiles of 16 rays a
warp), and whether a shape gives exactly the default's outputs is printed,
not held.

For each launch shape (threads a CTA aims at, rays a thread) it prints the
column groups, the resident CTAs and warps per SM and the median kernel
time over 5 runs, and checks that every shape (and the 2-stage ring) gives
exactly the outputs of the default. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from gpupathtracer_tpu_torch.ops import _build  # noqa: E402
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi  # noqa: E402
from gpupathtracer_tpu_torch.utils.config import load_scene_file  # noqa: E402

# (threads a CTA aims at, rays a thread); the groups follow (launch_shape)
# at the kernel's ray tile. K2 and K4 are built for one ray a thread only.
SHAPES = {
    "closest_hit": [(256, 2), (64, 2), (128, 2), (512, 2), (128, 1), (256, 1), (512, 1), (1024, 1)],
    "occlusion": [(1024, 1), (128, 1), (256, 1), (512, 1)],
    "closest_hit_streamed": [(256, 2), (64, 2), (128, 2), (192, 2), (512, 2), (256, 1), (512, 1), (1024, 1)],
    "occlusion_streamed": [(128, 1), (64, 1), (192, 1), (256, 1), (512, 1), (1024, 1)],
}


# The tensor-core route (LAUNCH_MMA): (threads a CTA aims at, m-tiles of 16
# rays a warp).
MMA_SHAPES = {
    "closest_hit": [(256, 1), (128, 2), (256, 2)],
    "occlusion": [(1024, 1), (256, 1), (512, 1), (512, 2), (1024, 2)],
    "closest_hit_streamed": [(512, 1), (256, 1), (128, 1), (256, 2), (512, 2)],
    "occlusion_streamed": [(256, 1), (128, 1), (512, 1), (256, 2), (512, 2)],
}
MMA_MODES = ("high", "mixed", "default")


def _same(got, want) -> bool:
    if isinstance(got, tuple):
        return all(torch.equal(a, b) for a, b in zip(got, want))
    return torch.equal(got, want)


def sweep(library: str, label: str, kernel, args) -> None:
    device = args[0].device
    ray_tile = args[-1]
    default = tpi.LAUNCH[library]
    want = kernel(*args)
    for shape in SHAPES[library]:
        tpi.LAUNCH[library] = shape
        try:
            occ = tpi.launch_occupancy(library, ray_tile)
            same = _same(kernel(*args), want)
            ms = cs.median_ms(lambda: kernel(*args), device)
        finally:
            tpi.LAUNCH[library] = default
        row = {"target_threads": shape[0], **occ, "ms": ms, "same_as_default": same}
        print(f"sweep {library} {label}: {json.dumps(row)}", flush=True)
        if not same:
            raise AssertionError(f"{library} at {shape} differs from the default shape {default}")


def sweep_mma(library: str, label: str, kernel, args) -> None:
    """sweep() for the tensor-core route of a kernel at each bf16 mode."""
    device = args[0].device
    ray_tile = args[-1]
    default = tpi.LAUNCH_MMA[library]
    for mode in MMA_MODES:
        run = lambda: kernel(*args, precision=mode)
        want = run()
        for shape in MMA_SHAPES[library]:
            tpi.LAUNCH_MMA[library] = shape
            try:
                occ = tpi.launch_occupancy(library, ray_tile, mode)
                same = _same(run(), want)
                ms = cs.median_ms(run, device)
            finally:
                tpi.LAUNCH_MMA[library] = default
            row = {"target_threads": shape[0], **occ, "ms": ms, "same_as_default": same}
            print(f"sweep {library} {label} at {mode}: {json.dumps(row)}", flush=True)


def mma() -> None:
    device = torch.device("cuda")
    scene, camera, settings = load_scene_file(cs.NEE_SCENE, device=device)
    settings = dataclasses.replace(settings, spp=4)
    packed = tpi.pack_scene(scene, tri_block=settings.tri_block)
    packed2 = tpi.pack_scene(scene, tri_block=settings.tri_block_secondary)
    sweep_mma("occlusion", "bounce-1 shadow rays", tpi.occluded,
              cs.nee_shadow_inputs(scene, camera, settings, packed, packed2, "occluded_reference"))
    scene, camera, settings = load_scene_file(cs.STREAM_SCENE, device=device)
    nee = dataclasses.replace(settings, spp=2, estimator="nee")
    packed = tpi.pack_scene(scene, tri_block=nee.tri_block)
    packed2 = tpi.pack_scene(scene, tri_block=nee.tri_block_secondary)
    sweep_mma("occlusion_streamed", "bounce-1 shadow rays", tpi.occluded_streamed,
              cs.nee_shadow_inputs(scene, camera, nee, packed, packed2, "occluded_streamed_reference"))
    del scene, packed, packed2
    scene, camera, settings = load_scene_file(cs.SCENE, device=device)
    settings = dataclasses.replace(settings, spp=4)
    packed = tpi.pack_scene(scene, tri_block=settings.tri_block)
    packed2 = tpi.pack_scene(scene, tri_block=settings.tri_block_secondary)
    (o, d), (o2, d2) = cs.main_path_rays(scene, camera, settings, packed)
    ray_tile = tpi.DEFAULT_RAY_TILE
    sweep_mma("closest_hit", "camera rays", tpi.closest_hit, tpi.prepare_rays(o, d, packed) + (packed.w, ray_tile))
    sweep_mma("closest_hit", "bounce-1 rays", tpi.closest_hit,
              tpi.prepare_rays(o2, d2, packed2) + (packed2.w, ray_tile))
    scene, camera, settings = load_scene_file(cs.STREAM_SCENE, device=device)
    settings = dataclasses.replace(settings, spp=2)
    packed = tpi.pack_scene(scene, tri_block=settings.tri_block)
    packed2 = tpi.pack_scene(scene, tri_block=settings.tri_block_secondary)
    (o, d), (o2, d2) = cs.main_path_rays(scene, camera, settings, packed)
    ray_tile = tpi.STREAM_RAY_TILE
    sweep_mma("closest_hit_streamed", "camera rays", tpi.closest_hit_streamed,
              tpi.prepare_rays_streamed(o, d, packed) + (ray_tile,))
    sweep_mma("closest_hit_streamed", "bounce-1 rays", tpi.closest_hit_streamed,
              tpi.prepare_rays_streamed(o2, d2, packed2) + (ray_tile,))


def two_stage_libraries(names) -> dict:
    """The named libraries built from a copy of csrc/ whose ring has 2
    stages, loaded as _build.library loads the real ones."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = tempfile.mkdtemp(prefix="two_stage_", dir=_build.BUILD_DIR)
    try:
        shutil.copytree(_build.CSRC, os.path.join(out, "csrc"))
        header = os.path.join(out, "csrc", "stream_stage.cuh")
        with open(header) as f:
            text = f.read()
        if text.count("constexpr int STAGES = 3;") != 1:
            raise RuntimeError("stream_stage.cuh no longer sets STAGES = 3 in one place")
        with open(header, "w") as f:
            f.write(text.replace("constexpr int STAGES = 3;", "constexpr int STAGES = 2;"))
        libs = {}
        for name in names:
            so = os.path.join(out, f"lib{name}.so")
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, os.path.join(out, "csrc", f"{name}.cu")],
                           check=True)
            lib = ctypes.CDLL(so)
            getattr(lib, f"{name}_launch").argtypes = _build.LAUNCHES[name][f"{name}_launch"]
            getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
            libs[name] = lib
        return libs
    finally:
        shutil.rmtree(out)  # the loaded libraries stay mapped


def two_stage(library: str, label: str, kernel, args, libs: dict) -> None:
    """The kernel with a 2-stage ring at the default launch shape."""
    device = args[0].device
    want = kernel(*args)
    real = _build.library
    _build.library = lambda name: libs[name] if name == library else real(name)
    try:
        same = _same(kernel(*args), want)
        ms = cs.median_ms(lambda: kernel(*args), device)
    finally:
        _build.library = real
    row = {"stages": 2, "launch": tpi.launch_shape(library, args[-1]), "ms": ms, "same_as_default": same}
    print(f"sweep {library} {label}: {json.dumps(row)}", flush=True)
    if not same:
        raise AssertionError(f"{library} with 2 stages differs from 3")


def resident() -> None:
    device = torch.device("cuda")
    ray_tile = tpi.DEFAULT_RAY_TILE
    libs = two_stage_libraries(["closest_hit", "occlusion"])
    scene, camera, settings = load_scene_file(cs.SCENE, device=device)
    settings = dataclasses.replace(settings, spp=4)
    packed = tpi.pack_scene(scene, tri_block=settings.tri_block)
    packed2 = tpi.pack_scene(scene, tri_block=settings.tri_block_secondary)
    (o, d), (o2, d2) = cs.main_path_rays(scene, camera, settings, packed)
    for label, args in (("camera rays", tpi.prepare_rays(o, d, packed) + (packed.w, ray_tile)),
                        ("bounce-1 rays", tpi.prepare_rays(o2, d2, packed2) + (packed2.w, ray_tile))):
        sweep("closest_hit", label, tpi.closest_hit, args)
        two_stage("closest_hit", label, tpi.closest_hit, args, libs)
    del o, d, o2, d2
    scene, camera, settings = load_scene_file(cs.NEE_SCENE, device=device)
    settings = dataclasses.replace(settings, spp=4)
    packed = tpi.pack_scene(scene, tri_block=settings.tri_block)
    packed2 = tpi.pack_scene(scene, tri_block=settings.tri_block_secondary)
    args = cs.nee_shadow_inputs(scene, camera, settings, packed, packed2, "occluded_reference")
    sweep("occlusion", "bounce-1 shadow rays", tpi.occluded, args)
    two_stage("occlusion", "bounce-1 shadow rays", tpi.occluded, args, libs)


def streamed() -> None:
    device = torch.device("cuda")
    scene, camera, settings = load_scene_file(cs.STREAM_SCENE, device=device)
    settings = dataclasses.replace(settings, spp=2)
    packed = tpi.pack_scene(scene, tri_block=settings.tri_block)
    packed2 = tpi.pack_scene(scene, tri_block=settings.tri_block_secondary)
    (o, d), (o2, d2) = cs.main_path_rays(scene, camera, settings, packed)
    ray_tile = tpi.STREAM_RAY_TILE
    sweep("closest_hit_streamed", "camera rays", tpi.closest_hit_streamed,
          tpi.prepare_rays_streamed(o, d, packed) + (ray_tile,))
    sweep("closest_hit_streamed", "bounce-1 rays", tpi.closest_hit_streamed,
          tpi.prepare_rays_streamed(o2, d2, packed2) + (ray_tile,))
    del o, d, o2, d2
    nee = dataclasses.replace(settings, estimator="nee")
    sweep("occlusion_streamed", "bounce-1 shadow rays", tpi.occluded_streamed,
          cs.nee_shadow_inputs(scene, camera, nee, packed, packed2, "occluded_streamed_reference"))


def main() -> None:
    which = sys.argv[1:] or ["resident", "streamed"]
    runs = {"resident": resident, "streamed": streamed, "mma": mma}
    if any(w not in runs for w in which):
        raise SystemExit(f"usage: {sys.argv[0]} [resident|streamed|mma]")
    cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    for w in which:
        runs[w]()


if __name__ == "__main__":
    main()
