"""The comparison that decides ``correct``, in the parts every loop kind
shares: the benchmark's plain reference (``reference/``) set up for a cell,
which builds the scene from the same configuration file with its own code
and traces the same paths with an exact search, and the rules of the
numbers that the loops' judges (``loops/``) compare.

- ``diverged_px_share``: the share of compared pixels where the program's
  image and the reference's differ by more than ``PIXEL_TOL`` in a channel
  (or are not finite). Where both find the same triangles the two images
  agree to the bit; a path that takes another triangle somewhere usually
  keeps its radiance, and where it does not, the pixel diverges.
- A gradient, a loss or a change is compared by the gap of norms
  (``gap``): the program's norm against the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is larger.

Each number is held to its limit in ``limits/<cell>.json`` (``verdict``).
The reference also counts the box crossings of the checked paths' rays,
the roofline's work (``roofline.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from h100_bench.reference import scene as ref_scene
from h100_bench.reference import trace as ref_trace

PIXEL_TOL = 1e-4


@dataclasses.dataclass
class Reference:
    """The reference set up for a cell's configuration."""

    scene: ref_scene.RefScene
    boxes: ref_trace.Boxes
    camera: ref_scene.RefCamera
    bounces: int
    estimator: str  # the configuration's ``render.estimator``: ``reference/<estimator>.py``

    def stats(self) -> list:
        return [ref_trace.BounceStats() for _ in range(self.bounces)]

    def trace(self, pixels, seed: int, spp: int, scene=None, **kwargs) -> torch.Tensor:
        """``reference.trace.trace_pixels`` of this configuration (of
        ``scene`` in its place: the same triangles with leaves in them)."""
        return ref_trace.trace_pixels(scene or self.scene, self.boxes, self.camera, pixels, seed, spp, self.bounces,
                                      estimator=self.estimator, **kwargs)


def reference(cell, device) -> Reference:
    cfg = ref_scene.load_config(cell.config_file)
    scene = ref_scene.build_scene(cfg, device)
    render = cfg["render"]
    return Reference(scene=scene, boxes=ref_trace.build_boxes(scene), camera=ref_scene.build_camera(cfg),
                     bounces=int(render["bounces"]), estimator=render.get("estimator", "naive"))


def diverged(got: torch.Tensor, want: torch.Tensor) -> int:
    """Pixels (rows of 3 channels) that differ by more than ``PIXEL_TOL``."""
    return int((~((got - want).abs() <= PIXEL_TOL)).any(-1).sum())


def norm(x) -> float:
    return 0.0 if x is None else float(torch.linalg.norm(x.detach().double()))


def gap(got: float, want: float, median_leaf: float = 0.0) -> float:
    """The gap of two norms over the reference's norm of the leaf or of the
    median leaf, whichever is larger."""
    return abs(got - want) / max(abs(want), median_leaf, 1e-30)


def verdict(numbers: dict, limits: dict):
    """``(correct, rows)``: every number at or under its limit (a number
    that is not finite fails), and ``{name: {"value", "limit"}}``."""
    rows = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in rows.values())
    return ok, rows
