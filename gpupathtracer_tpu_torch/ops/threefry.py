"""The ``jax.random`` draws of the JAX package, bit for bit, in PyTorch.

The JAX package draws its edge samples (``grad/edges.py``), its inverse
demos' keys and its ``rng="threefry"`` path keys from ``jax.random``'s
default threefry2x32 engine. This module computes the same words: JAX's
algorithm with ``jax_threefry_partitionable`` on (the default since JAX
0.5), under which

- a key is two uint32 words, ``PRNGKey(seed) = (0, seed mod 2^32)``;
- ``fold_in(key, d) = threefry2x32(key, (0, d))``;
- ``split(key, n)[i] = threefry2x32(key, (0, i))``, so split is fold-like;
- ``random_bits(key, shape)`` hashes each element's flat index ``i`` as the
  counter pair ``(i >> 32, i & M32)`` and xors the two output words, so a
  draw depends only on each element's flat index: a large draw made in
  row chunks with the index offset (``row_start``) is exact;
- ``uniform`` fills the float32 mantissa (``bits >> 9 | 0x3F800000``, less
  1); ``randint`` reduces two words modulo the span as JAX does, with
  uint32 wrap-around; ``categorical`` is ``argmax(gumbel + logits)`` with
  the low-range Gumbel draw ``-log(-log(uniform(tiny, 1)))``, the first
  index winning ties.

Words are held in int64 tensors with values in [0, 2^32), as
``ops/sampling.py`` holds PCG words. A key is an int64 tensor ``(..., 2)``;
draws land on the key's device.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 words in int64, without int64 overflow:
    the product is formed from b's 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key words ``(k1, k2)``; all uint32 words in int64 tensors (or
    ints) that broadcast together. Returns the two output words."""
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    k2 = torch.as_tensor(k2, dtype=torch.int64, device=k1.device)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """The key of ``jax.random.PRNGKey(seed)`` with JAX's default 32-bit
    integers: words ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def key_data(key: torch.Tensor) -> tuple[int, int]:
    """A single key's two words as ints, in JAX's order (``jax.random.key_data``)."""
    hi, lo = key.tolist()
    return int(hi), int(lo)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for keys ``(..., 2)`` and an int, or
    an int64 tensor of data words that broadcasts with the key's batch
    shape (one fold per element, as ``vmap(fold_in)``)."""
    if isinstance(data, torch.Tensor):
        data = data & _M32
    else:
        data = int(data) & _M32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)``, the fold-like split."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=-1)


def _flat_index(shape, row_start: int, device) -> torch.Tensor:
    """Flat row-major element indices of ``shape``, offset by whole rows:
    the indices the elements of rows ``[row_start, row_start + shape[0])``
    have in a taller array with the same trailing dimensions."""
    n = 1
    for s in shape:
        n *= int(s)
    row = n // int(shape[0]) if len(shape) and shape[0] else 0
    return (torch.arange(n, dtype=torch.int64, device=device) + row_start * row).reshape(shape)


def random_bits(key: torch.Tensor, shape, row_start: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` (int64 words in [0, 2^32));
    ``row_start`` gives rows ``[row_start, row_start + shape[0])`` of a taller
    draw from the same key."""
    shape = tuple(int(s) for s in shape)
    i = _flat_index(shape, row_start, key.device)
    y1, y2 = threefry2x32(key[0], key[1], i >> 32, i & _M32)
    return y1 ^ y2


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the mantissa: bitcast(bits >> 9 | 0x3F800000) - 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0, row_start: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``. XLA
    contracts ``floats * (maxval - minval) + minval`` into one fused
    multiply-add; the float64 product and sum, rounded once, give its
    result (exactly so for the spans of 0..1 and tiny..1 that the renderer
    draws)."""
    floats = bits_to_unit(random_bits(key, shape, row_start))
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=key.device) - lo
    return torch.maximum((floats.double() * span.double() + lo.double()).float(), lo)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with int32 values
    (JAX's default), as int64: two words reduced modulo the span with
    uint32 products and sums that wrap, as JAX computes them."""
    if not -(2**31) <= minval <= maxval <= 2**31 - 1:
        raise ValueError("randint draws int32 values; minval and maxval must be int32 with minval <= maxval")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = (mul32(higher % span, multiplier) + lower % span) & _M32
    return minval + offset % span


def gumbel(key: torch.Tensor, shape, row_start: int = 0) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in JAX's default (low-range) mode."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_F32_TINY, row_start=row_start)))


def categorical(
    key: torch.Tensor, logits: torch.Tensor, axis: int = -1, shape=None, row_chunk: int | None = None
) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis, shape)`` (with replacement):
    ``argmax(gumbel + logits)`` along ``axis``, the first index winning ties
    and ``-inf`` lanes never winning over a finite one. ``logits`` is
    ``(..., E)`` with the categories on the last axis (``axis`` -1 or its
    positive equal). ``shape``, as in JAX, may prepend sample dimensions to
    the batch shape. ``row_chunk`` draws the Gumbel noise in chunks of that
    many rows of the flattened ``(samples, *batch, E)`` draw, with the
    counter offset, so the result is the same and the noise of only one
    chunk is held at a time."""
    if axis not in (-1, logits.dim() - 1):
        raise ValueError("categorical takes the categories on the last axis")
    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else tuple(int(s) for s in shape)
    if shape[len(shape) - len(batch):] != batch:
        raise ValueError(f"shape {shape} does not end with the batch shape {batch}")
    prefix = shape[: len(shape) - len(batch)]
    n_prefix = 1
    for s in prefix:
        n_prefix *= s
    e = logits.shape[-1]
    flat_logits = logits.reshape(-1, e)  # (B, E)
    b = flat_logits.shape[0]
    rows = n_prefix * b
    step = rows if row_chunk is None else max(int(row_chunk), 1)
    out = []
    for r0 in range(0, rows, step):
        r1 = min(r0 + step, rows)
        g = gumbel(key, (r1 - r0, e), row_start=r0)
        if b == 1:
            lg = flat_logits
        elif n_prefix == 1:
            lg = flat_logits[r0:r1]
        else:
            lg = flat_logits[torch.arange(r0, r1, device=logits.device) % b]
        out.append(torch.argmax(g + lg, dim=-1))
    return torch.cat(out).reshape(shape)
