"""Sampling warps, shading frames and the two counter-based path samplers.

Counterpart of ``gpupathtracer_tpu/ops/sampling.py``. Both samplers are
stateless and depend only on logical ids, and match the JAX package's bit
for bit. ``PcgSampler`` (``rng="pcg"``): a key is four uint32 words (seed,
pixel, sample, stream) and every draw is one PCG4D evaluation.
``ThreefrySampler`` (``rng="threefry"``): a key is two words of
``jax.random``'s threefry engine (``ops/threefry.py``), folded with the
sample and pixel ids.

torch has no uint32 arithmetic, so words are held in int64 tensors with
values in [0, 2^32). Every add is masked back to 32 bits, products are
formed from 16-bit halves so no int64 product overflows, and every shift
acts on non-negative values, so ``>>`` is a logical shift.

Every sampler's ``path_keys``, ``fold`` and ``uniform`` runs in a
``render.rng`` span (``utils/profiling.py``) while a profiler records.
"""

from __future__ import annotations

import functools
import math

import torch

from gpupathtracer_tpu_torch.core.tensors import clip, maximum
from gpupathtracer_tpu_torch.ops import threefry
from gpupathtracer_tpu_torch.ops.threefry import mul32 as _mul32
from gpupathtracer_tpu_torch.utils.profiling import scope

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # odd multiplier: fold chains stay injective


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """PCG4D mixing function over uint32 words: (..., 4) int64 -> (..., 4)."""
    v = (_mul32(v, 1664525) + 1013904223) & _M32
    x, y, z, w = v.unbind(-1)
    x = (x + _mul32(y, w)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    w = (w + _mul32(y, z)) & _M32
    x, y, z, w = (a ^ (a >> 16) for a in (x, y, z, w))
    x = (x + _mul32(y, w)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    w = (w + _mul32(y, z)) & _M32
    return torch.stack([x, y, z, w], dim=-1)


def _uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    # Top 24 bits → [0, 1) with full float32 mantissa coverage.
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def prng_key_data(seed: int) -> tuple[int, int]:
    """The two uint32 words of ``jax.random.PRNGKey(seed)`` with JAX's
    default 32-bit integers: ``(0, seed mod 2^32)``."""
    return 0, int(seed) & _M32


class PcgSampler:
    """Stateless counter-based sampler: key rows are (seed, pixel, sample,
    stream) uint32 words in int64; every draw is one PCG4D evaluation.

    Keys are single-use: fold a fresh stream with ``fold`` before every
    ``uniform`` call (two calls on one key return the same values)."""

    @staticmethod
    def path_keys(key_data, pixel_idx: torch.Tensor, sample_idx: int) -> torch.Tensor:
        hi, lo = (int(k) & _M32 for k in key_data)
        seed = (lo + (hi * 2654435761 & _M32)) & _M32
        r = pixel_idx.shape[0]
        dev = pixel_idx.device
        return torch.stack(
            [
                torch.full((r,), seed, dtype=torch.int64, device=dev),
                pixel_idx.to(torch.int64) & _M32,
                torch.full((r,), int(sample_idx) & _M32, dtype=torch.int64, device=dev),
                torch.zeros((r,), dtype=torch.int64, device=dev),
            ],
            dim=-1,
        )

    @staticmethod
    def fold(keys: torch.Tensor, c: int) -> torch.Tensor:
        stream = (_mul32(keys[..., 3], _GOLDEN) + (int(c) & _M32)) & _M32
        return torch.cat([keys[..., :3], stream[..., None]], dim=-1)

    @staticmethod
    def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
        """n ≤ 4 floats in [0, 1) per lane — one PCG4D evaluation of the key."""
        if not 1 <= n <= 4:
            raise ValueError("one PCG4D draw yields at most 4 words")
        return _uniform_from_bits(pcg4d(keys)[..., :n])


def pixel_sample_key(key_data, pixel_idx: torch.Tensor, sample_idx: int) -> torch.Tensor:
    """Threefry keys (R, 2) per (pixel, sample): the sample id, then each
    pixel id, folded into the base key's two words ``key_data``. They depend
    only on the logical ids, never on how the pixels are laid out."""
    base = torch.tensor([int(k) & _M32 for k in key_data], dtype=torch.int64, device=pixel_idx.device)
    return threefry.fold_in(threefry.fold_in(base, sample_idx), pixel_idx.to(torch.int64))


class ThreefrySampler:
    """``jax.random``'s threefry engine behind the same interface, batched
    over lanes: key rows are the two words of a threefry key (int64, R × 2).
    ``path_keys`` is ``pixel_sample_key``; ``fold`` folds a stream constant
    into every row; ``uniform`` is ``jax.random.uniform(key, (n,))`` of
    every row."""

    path_keys = staticmethod(pixel_sample_key)

    @staticmethod
    def fold(keys: torch.Tensor, c: int) -> torch.Tensor:
        return threefry.fold_in(keys, c)

    @staticmethod
    def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
        """n floats in [0, 1) per lane: the threefry words of counters 0..n-1."""
        i = torch.arange(n, dtype=torch.int64, device=keys.device)
        y1, y2 = threefry.threefry2x32(keys[:, 0:1], keys[:, 1:2], 0, i)
        return threefry.bits_to_unit(y1 ^ y2)


SAMPLERS = {"pcg": PcgSampler, "threefry": ThreefrySampler}


def _rng_span(fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with scope("render.rng"):
            return fn(*args, **kwargs)

    return staticmethod(spanned)


for _sampler in SAMPLERS.values():
    for _method in ("path_keys", "fold", "uniform"):
        setattr(_sampler, _method, _rng_span(getattr(_sampler, _method)))
del _sampler, _method


def make_sampler(impl: str):
    """The sampler class of ``rng`` name ``impl``."""
    try:
        return SAMPLERS[impl]
    except KeyError:
        raise ValueError(f"unknown rng impl {impl!r}; expected one of {sorted(SAMPLERS)}") from None


def path_keys(seed: int, ids: torch.Tensor, sample_idx: int = 0, impl: str = "pcg") -> torch.Tensor:
    """Per-lane path keys for seed ``seed``, as the JAX package's
    ``path_keys(seed, ids, sample_idx, impl)`` makes them."""
    return make_sampler(impl).path_keys(prng_key_data(seed), ids, sample_idx)


def cosine_sample_hemisphere(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """The reference's square → cosine-hemisphere warp (+z = normal)."""
    r = torch.sqrt(u1)
    theta = 2.0 * math.pi * u2
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)


def cosine_hemisphere_pdf(cos_theta: torch.Tensor) -> torch.Tensor:
    return cos_theta / math.pi


def make_onb(n: torch.Tensor):
    """Branchless orthonormal basis around unit normal n (..., 3)
    (Duff et al. 2017)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    t = torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], dim=-1)
    bvec = torch.stack([b, sign + y * y * a, -y], dim=-1)
    return t, bvec


def local_to_world(local: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Rotate local (+z = normal) directions into the world frame."""
    t, b = make_onb(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def normalize_dir(v: torch.Tensor) -> torch.Tensor:
    """v / |v|, with the squared length clamped inside the sqrt so that a
    zero vector's gradient is 0, not NaN."""
    return v / torch.sqrt(maximum((v * v).sum(dim=-1, keepdim=True), 1e-24))


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of incident direction d about normal n."""
    return d - 2.0 * (d * n).sum(dim=-1, keepdim=True) * n


def refract(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Refraction of incident d through normal n (facing against d) with
    relative IOR eta (..., 1). Returns ``(refracted_dir, tir)``, where
    ``tir`` marks total internal reflection. cos_t's argument is clamped to
    [1e-12, 1]: sqrt'(0) would NaN the backward on TIR lanes, which are
    masked out anyway."""
    cos_i = -(d * n).sum(dim=-1, keepdim=True)
    sin2_t = eta * eta * maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t[..., 0] >= 1.0
    cos_t = torch.sqrt(clip(1.0 - sin2_t, 1e-12, 1.0))
    return eta * d + (eta * cos_i - cos_t) * n, tir


def fresnel_schlick(cos_i: torch.Tensor, eta_i: torch.Tensor, eta_t: torch.Tensor) -> torch.Tensor:
    """Schlick's Fresnel reflectance. The powers are products in the order
    JAX lowers ``** 2`` and ``** 5`` (x·x; x·((x·x)·(x·x))), so the result
    is the same to the bit."""
    q = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = q * q
    x = 1.0 - cos_i
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))
