"""Image IO for texture files.

Counterpart of ``read_ppm`` in ``gpupathtracer_tpu/utils/image.py`` (numpy
only; copied so that the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM → (H, W, 3) uint8. Values above ``maxval`` are
    clamped on read."""
    with open(path, "r") as f:
        tokens: list[str] = []
        for line in f:
            hash_pos = line.find("#")
            if hash_pos >= 0:
                line = line[:hash_pos]
            tokens.extend(line.split())
    if not tokens or tokens[0] != "P3":
        raise ValueError(f"{path}: not an ASCII PPM (P3)")
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    data = np.asarray(tokens[4 : 4 + w * h * 3], dtype=np.int64)
    return np.clip(data, 0, maxv).astype(np.uint8).reshape(h, w, 3)
