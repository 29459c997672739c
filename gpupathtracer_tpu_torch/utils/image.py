"""Image IO: PPM (the reference's ASCII P3) and PNG.

Counterpart of ``gpupathtracer_tpu/utils/image.py`` (numpy and the standard
library only; copied so that the port imports nothing of the JAX package).
``write_ppm`` writes the reference's ``saveToPPM`` format: "P3", "<w> <h>",
"255", then one RGB triple per line.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_ppm(path: str, u8_image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an ASCII P3 PPM."""
    h, w = u8_image.shape[:2]
    flat = u8_image.reshape(-1, 3).astype(np.int64)
    with open(path, "w") as f:
        f.write("P3\n")
        f.write(f"{w} {h}\n")
        f.write("255\n")
        np.savetxt(f, flat, fmt="%d")


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


def write_png(path: str, u8_image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (zlib from the
    standard library; no imaging package needed)."""
    img = np.ascontiguousarray(u8_image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)  # filter 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(chunk(b"IEND", b""))


def write_image(path: str, u8_image: np.ndarray) -> None:
    """PPM for a ``.ppm`` path, PNG otherwise."""
    if path.endswith(".ppm"):
        write_ppm(path, u8_image)
    else:
        write_png(path, u8_image)
