"""The port's copy of ``jax.random``'s threefry draws (``ops/threefry.py``)
against ``jax.random`` itself, the ``rng="threefry"`` sampler against the
JAX package's, and renders through the threefry sampler and through the
brute intersector against the JAX package's ``render_frame``.

Keys, splits, folds, bits, uniforms and randints are bit-equal. Gumbel noise
is ``-log(-log(u))`` of bit-equal uniforms, and XLA's ``log`` on the CPU
and PyTorch's differ by an ulp on some inputs, so the noise agrees to a few
ulps, not bit for bit; the categorical picks (argmax of noise plus logits)
are equal on every draw checked here, since a flip needs two candidates
within an ulp of each other. Renders meet the image bar of
``tests/test_torch_render.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import _resized, assert_image_bar

from gpupathtracer_tpu.ops import sampling as js
from gpupathtracer_tpu.render.renderer import render_frame as j_render
from gpupathtracer_tpu_torch.ops import sampling as ts
from gpupathtracer_tpu_torch.ops import threefry as tf
from gpupathtracer_tpu_torch.render.renderer import render_frame

SEEDS = [0, 3, 9, 1234, 2**31 - 1, 2**32 + 7]


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64) if np.asarray(x).dtype.kind in "iu" else np.asarray(x)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    assert tf.key_data(tk) == tuple(int(w) for w in np.asarray(jk))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(tf.split(tk, num).numpy(), _np(jax.random.split(jk, num)))
    for data in (0, 1, 128, 0x5EC2, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(tf.fold_in(tk, data).numpy(), _np(jax.random.fold_in(jk, data)))
    # A batch of keys folded with a tensor of words, as vmap(fold_in) does.
    keys = tf.split(tk, 5)
    words = torch.tensor([0, 7, 2**20, 2**32 - 1, 3])
    want = jax.vmap(jax.random.fold_in)(jax.random.split(jk, 5), jnp.asarray(words.numpy(), jnp.uint32))
    np.testing.assert_array_equal(tf.fold_in(keys, words).numpy(), _np(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    for shape in [(1,), (7,), (3, 5), (4, 3, 2), (1024,)]:
        np.testing.assert_array_equal(tf.random_bits(tk, shape).numpy(), _np(jax.random.bits(jk, shape, jnp.uint32)))
        np.testing.assert_array_equal(tf.uniform(tk, shape).numpy(), np.asarray(jax.random.uniform(jk, shape)))
        np.testing.assert_array_equal(
            tf.uniform(tk, shape, -2.0, 3.0).numpy(), np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0))
        )


@pytest.mark.parametrize("lo,hi", [(0, 10), (0, 640000), (5, 7), (-3, 2**31 - 1), (0, 1), (4, 4)])
def test_randint_bit_equal(lo, hi):
    for seed in SEEDS:
        want = jax.random.randint(jax.random.PRNGKey(seed), (257,), lo, hi)
        np.testing.assert_array_equal(tf.randint(tf.PRNGKey(seed), (257,), lo, hi).numpy(), _np(want))


def test_row_chunks_equal_the_whole_draw():
    """Bits depend only on the flat index: rows drawn with ``row_start``
    are the rows of the whole draw, and chunked categorical picks are the
    whole draw's."""
    key = tf.PRNGKey(17)
    whole = tf.random_bits(key, (10, 6))
    for r0, r1 in [(0, 3), (3, 7), (7, 10), (9, 10)]:
        torch.testing.assert_close(tf.random_bits(key, (r1 - r0, 6), row_start=r0), whole[r0:r1], rtol=0, atol=0)
        torch.testing.assert_close(tf.uniform(key, (r1 - r0, 6), row_start=r0), tf.uniform(key, (10, 6))[r0:r1],
                                   rtol=0, atol=0)
    logits = torch.log(torch.rand(300, generator=torch.Generator().manual_seed(1)))
    full = tf.categorical(key, logits, shape=(1000,))
    for chunk in (1, 77, 999, 4096):
        assert torch.equal(tf.categorical(key, logits, shape=(1000,), row_chunk=chunk), full)
    batched = logits.reshape(30, 10)
    assert torch.equal(tf.categorical(key, batched, shape=(4, 30), row_chunk=7),
                       tf.categorical(key, batched, shape=(4, 30)))


def _logit_cases():
    rng = np.random.default_rng(5)
    flat = np.log(rng.uniform(0, 1, 500)).astype(np.float32)
    flat[::7] = -np.inf
    batched = np.log(rng.uniform(0, 1, (128, 40))).astype(np.float32)
    batched[:, ::3] = -np.inf
    batched[5] = 0.0  # an empty row, zeroed as grad/edges.py zeroes it
    near_tie = np.zeros(64, np.float32)  # equal logits: every pick is decided by the noise alone
    return {"flat sample prefix": (flat, (2048,)), "batched rows": (batched, None), "equal logits": (near_tie, (4096,))}


@pytest.mark.parametrize("case", list(_logit_cases()))
def test_categorical_picks_equal_jax(case):
    logits, shape = _logit_cases()[case]
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits), axis=-1, shape=shape))
        got = tf.categorical(tk, torch.as_tensor(logits), axis=-1, shape=shape).numpy()
        np.testing.assert_array_equal(got, want)


def test_gumbel_agrees_to_log_rounding():
    """The Gumbel noise is -log(-log(u)) of bit-equal uniforms; the two
    libraries' log differ by an ulp on some inputs, so the noise agrees to
    a few ulps."""
    for seed in SEEDS:
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (64, 50)))
        got = tf.gumbel(tf.PRNGKey(seed), (64, 50)).numpy()
        np.testing.assert_array_equal(tf.uniform(tf.PRNGKey(seed), (64, 50), minval=float(np.finfo(np.float32).tiny))
                                      .numpy(),
                                      np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (64, 50),
                                                                    minval=np.finfo(np.float32).tiny)))
        # In units of the spacing at max(|g|, 1): near g = 0 the outer log
        # turns an ulp of the inner one into many ulps of a tiny value.
        ulps = np.abs(got - want) / np.spacing(np.maximum(np.abs(want), 1.0))
        assert ulps.max() <= 4, ulps.max()


@pytest.mark.parametrize("seed", [0, 1234, 2**31 - 1])
def test_threefry_sampler_bit_equal(seed):
    rng = np.random.default_rng(seed % 1000)
    pixels = np.concatenate([np.arange(32), rng.integers(0, 2**24, size=96)]).astype(np.uint32)
    for sample in (0, 1, 255):
        jk = js.path_keys(seed, jnp.asarray(pixels), sample, impl="threefry")
        tk = ts.path_keys(seed, torch.as_tensor(pixels.astype(np.int64)), sample, impl="threefry")
        np.testing.assert_array_equal(tk.numpy(), _np(jk))
        for c in (0, 7919, 0xA11A, 0x11EE):
            jf, tfk = js.ThreefrySampler.fold(jk, c), ts.ThreefrySampler.fold(tk, c)
            np.testing.assert_array_equal(tfk.numpy(), _np(jf))
            for n in (1, 2, 3):
                np.testing.assert_array_equal(ts.ThreefrySampler.uniform(tfk, n).numpy(),
                                              np.asarray(js.ThreefrySampler.uniform(jf, n)))


@pytest.mark.parametrize("seed", [0, 1234, 2**31 - 1])
def test_pixel_sample_key_bit_equal(seed):
    pixels = np.random.default_rng(seed % 1000).integers(0, 2**24, size=64).astype(np.uint32)
    for sample in (0, 1, 255):
        want = js.pixel_sample_key(jax.random.PRNGKey(seed), jnp.asarray(pixels), sample)
        got = ts.pixel_sample_key(ts.prng_key_data(seed), torch.as_tensor(pixels.astype(np.int64)), sample)
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize(
    "change",
    [
        {"rng": "threefry"},
        {"rng": "threefry", "estimator": "nee"},
        {"intersector": "brute"},
        {"intersector": "brute", "estimator": "mis", "tri_block": 8, "ray_chunk": 64},
    ],
    ids=["threefry naive", "threefry nee", "brute naive", "brute mis, small blocks and chunks"],
)
def test_render_matches_jax(change):
    (js_, jc, jst), (ts_, tc, tst) = _resized("config5_invert_target.toml", 16, 2)
    jst, tst = dataclasses.replace(jst, **change), dataclasses.replace(tst, **change)
    want = np.asarray(j_render(js_, jc, jst))
    got = render_frame(ts_, tc, tst, device="cpu").numpy()
    assert want.mean() > 0.05
    assert_image_bar(got, want)


def test_threefry_and_pcg_frames_differ():
    """The rng option reaches the sampler: the two engines draw different paths."""
    (_, _, _), (ts_, tc, tst) = _resized("config5_invert_target.toml", 16, 2)
    a = render_frame(ts_, tc, tst, device="cpu")
    b = render_frame(ts_, tc, dataclasses.replace(tst, rng="threefry"), device="cpu")
    assert not torch.equal(a, b)


def test_unknown_rng_raises():
    (_, _, _), (ts_, tc, tst) = _resized("config5_invert_target.toml", 8, 1)
    with pytest.raises(ValueError, match="rng"):
        render_frame(ts_, tc, dataclasses.replace(tst, rng="philox"), device="cpu")
