"""Back-to-back forward frames through the program's ``render_frame``.

Traffic parameters: ``spp``; ``warmup``, frames that set-up renders (other
seeds); ``check_frames``, the frames of the window that the check keeps (a
seeded reservoir sample); ``check_pixels``, the pixels of each that it
compares (0: all; else a sample drawn from the frame's seed). Each frame
takes a new sample seed drawn from the run's seed.

Compared: ``diverged_px_share`` (``check.diverged``) over the kept frames.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import check, drive, faults


class Loop(drive.Program):
    """Forward frames; keeps a seeded reservoir sample of the window's."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        warm = drive.seed_stream(seed, "warmup")
        for _ in range(int(self.traffic["warmup"])):
            self.render_frame(self.scene, self.camera, self.settings, seed=drive.draw_seed(warm), device=device)
        drive.sync(device)
        self.kept = []  # (index, frame seed, image)
        self._pick = drive.seed_stream(seed, "check")

    def item(self, i: int) -> None:
        s = drive.draw_seed(self.item_seeds)
        with torch.profiler.record_function("h100_bench.frame"):
            img = self.render_frame(self.scene, self.camera, self.settings, seed=s, device=self.device)
        drive.sync(self.device)
        k = int(self.traffic["check_frames"])
        if len(self.kept) < k:
            self.kept.append((i, s, img))
        else:
            j = int(self._pick.integers(0, i + 1))
            if j < k:
                self.kept[j] = (i, s, img)

    def record(self) -> dict:
        return {"frames": [(s, img.detach()) for _, s, img in sorted(self.kept, key=lambda x: x[0])]}


def judge(cell, record: dict, device):
    """``(numbers, work)`` for the frames the loop kept."""
    t = cell.traffic
    ref = check.reference(cell, device)
    spp = int(t["spp"])
    npix = ref.camera.width * ref.camera.height
    stats = ref.stats()
    diverged = compared = 0
    for seed, image in record["frames"]:
        n = int(t["check_pixels"]) or npix
        pick = drive.seed_stream(seed, "pixels")
        pixels = torch.as_tensor(np.sort(pick.choice(npix, size=min(n, npix), replace=False)), device=device)
        want = ref.trace(pixels, seed, spp, count_rays=int(t["work_rays"]), stats=stats) / spp
        diverged += check.diverged(image.reshape(-1, 3)[pixels], want)
        compared += pixels.numel()
    share = diverged / compared if compared else float("inf")
    return {"diverged_px_share": share}, stats


FAULTS = {"half_batch": faults.half_batch, "altered_answer": faults.altered_answer}
