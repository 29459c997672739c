"""Film: sample accumulation and image conversion.

Counterpart of ``gpupathtracer_tpu/render/film.py``: a float32 (sum, count)
accumulator, so resuming or merging renders is an add.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpupathtracer_tpu_torch.core.tensors import resolve_device


@dataclasses.dataclass(frozen=True)
class Film:
    """Accumulated radiance sums and the sample count."""

    radiance_sum: torch.Tensor  # (H, W, 3) float32
    sample_count: torch.Tensor  # () float32

    @classmethod
    def zeros(cls, height: int, width: int, device="cuda") -> "Film":
        device = resolve_device(device)
        return cls(
            radiance_sum=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            sample_count=torch.zeros((), dtype=torch.float32, device=device),
        )

    def add_samples(self, radiance_hw3: torch.Tensor, count: float = 1.0) -> "Film":
        return Film(
            radiance_sum=self.radiance_sum + radiance_hw3,
            sample_count=self.sample_count + count,
        )

    def to_image(self) -> torch.Tensor:
        """Mean radiance (H, W, 3) float32."""
        return self.radiance_sum / torch.clamp(self.sample_count, min=1.0)


def to_u8(image, gamma: float | None = None) -> np.ndarray:
    """float radiance → u8 (× 255, clamped to [0, 255]), optionally
    gamma-encoded first."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    img = np.asarray(image, np.float32)
    if gamma:
        img = np.power(np.maximum(img, 0.0), 1.0 / gamma)
    return np.clip(img * 255.0, 0.0, 255.0).astype(np.uint8)
