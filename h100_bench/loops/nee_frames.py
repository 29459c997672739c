"""Back-to-back forward frames under next-event estimation: the loop of
``frames.py`` (its traffic parameters), a judge that differs from its judge
only in the reference's camera, and one more fault.

Compared: ``diverged_px_share`` (``check.diverged``) over the kept frames,
against ``reference/nee.py``'s ``trace_pixels``, whose camera rays are the
float32 ones of the published viewer (see that module: the light sample's
geometry term sees where on a triangle a path lands, which the float64
camera of ``trace.trace_pixels`` moves at grazing angles).

Faults: ``frames.py``'s ``altered_answer``, and

- ``altered_shadow``: the any-hit search flips the answer of every 16th
  shadow ray, where the answer is produced (bounces after the first; the
  first thresholds a closest hit, which ``altered_answer`` alters).

``half_batch`` is not among them: it keeps max(1, spp // 2) samples, so at
spp 1 it keeps the one sample and changes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import check, drive, faults
from h100_bench.loops import frames
from h100_bench.reference import nee

Loop = frames.Loop


def judge(cell, record: dict, device):
    """``(numbers, work)`` for the frames the loop kept."""
    t = cell.traffic
    ref = check.reference(cell, device)
    if ref.estimator != "nee":
        raise ValueError(f"the nee_frames loop judges NEE frames, not {ref.estimator!r} ones")
    spp = int(t["spp"])
    npix = ref.camera.width * ref.camera.height
    stats = ref.stats()
    diverged = compared = 0
    for seed, image in record["frames"]:
        n = int(t["check_pixels"]) or npix
        pick = drive.seed_stream(seed, "pixels")
        pixels = torch.as_tensor(np.sort(pick.choice(npix, size=min(n, npix), replace=False)), device=device)
        want = nee.trace_pixels(ref.scene, ref.boxes, ref.camera, pixels, seed, spp, ref.bounces,
                                count_rays=int(t["work_rays"]), stats=stats) / spp
        diverged += check.diverged(image.reshape(-1, 3)[pixels], want)
        compared += pixels.numel()
    share = diverged / compared if compared else float("inf")
    return {"diverged_px_share": share}, stats


def altered_shadow():
    from gpupathtracer_tpu_torch.ops import packed_intersect

    def make(original):
        def intersect_packed_occluded(*args, **kwargs):
            occ = original(*args, **kwargs).clone()
            occ[::16] = ~occ[::16]
            return occ
        return intersect_packed_occluded

    return faults._patched(packed_intersect, "intersect_packed_occluded", make)


FAULTS = {"altered_answer": frames.FAULTS["altered_answer"], "altered_shadow": altered_shadow}
