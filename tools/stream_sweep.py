"""Times the streamed kernels K3 and K4 of the PyTorch + CUDA port under
several launch shapes, at the streamed path's shapes, on one card.

    python3 tools/stream_sweep.py

Builds the inputs as chip_smoke.py's phases 9 and 11 do on
scenes/config6_icosphere.toml (640,000 camera rays at tb 256, 640,000
bounce-1 rays at tb 1024, bounce 1's NEE shadow rays at tb 1024; 64-ray
tiles), then for each launch shape (threads a CTA aims at, rays a thread)
prints the column groups, the resident CTAs and warps per SM and the median
kernel time over 5 runs, and checks that every shape gives exactly the
outputs of the default shape. Prints the card's name and power limit first.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi  # noqa: E402
from gpupathtracer_tpu_torch.utils.config import load_scene_file  # noqa: E402

# (threads a CTA aims at, rays a thread) at the 64-ray tile; the groups
# follow (stream_launch_shape). K4 is built for one ray a thread only.
SHAPES = {
    "closest_hit_streamed": [(256, 2), (64, 2), (128, 2), (192, 2), (512, 2), (256, 1), (512, 1), (1024, 1)],
    "occlusion_streamed": [(128, 1), (64, 1), (192, 1), (256, 1), (512, 1), (1024, 1)],
}


def sweep(library: str, label: str, kernel, args) -> None:
    device = args[0].device
    default = tpi.STREAM_LAUNCH[library]
    want = kernel(*args)
    for shape in SHAPES[library]:
        tpi.STREAM_LAUNCH[library] = shape
        try:
            occ = tpi.stream_occupancy(library, tpi.STREAM_RAY_TILE)
            got = kernel(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, want)) if isinstance(got, tuple) else torch.equal(got, want)
            ms = cs.median_ms(lambda: kernel(*args), device)
        finally:
            tpi.STREAM_LAUNCH[library] = default
        row = {"target_threads": shape[0], **occ, "ms": ms, "same_as_default": same}
        print(f"sweep {library} {label}: {json.dumps(row)}", flush=True)
        if not same:
            raise AssertionError(f"{library} at {shape} differs from the default shape {default}")


def main() -> None:
    cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
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


if __name__ == "__main__":
    main()
