"""The port's PCG4D sampler is bit-equal to the JAX package's, and the
sampling warps agree to float rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.ops import sampling as js
from gpupathtracer_tpu_torch.ops import _build
from gpupathtracer_tpu_torch.ops import sampling as ts

SEEDS = [0, 1, 1234, 2**31 - 1, 2**31, 2**32 - 1, -1]
SAMPLES = [0, 1, 3, 255, 2**31 + 5]
STREAMS = [0, 1, 7919, 0xA11A, 0x11EE, 2**31 - 1]  # JAX takes int32 stream constants


def _u32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64))


def test_pcg4d_bit_equal():
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, size=(4096, 4), dtype=np.uint64).astype(np.uint32)
    words[:4] = [[0, 0, 0, 0], [2**32 - 1] * 4, [1, 2, 3, 4], [2**31, 2**31 - 1, 2**16, 2**16 - 1]]
    want = np.asarray(js.pcg4d(jnp.asarray(words)))
    got = ts.pcg4d(_u32(words)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_path_keys_fold_uniform_bit_equal(seed):
    rng = np.random.default_rng(abs(seed) % 1000)
    pixels = np.concatenate([np.arange(64), rng.integers(0, 2**24, size=192)]).astype(np.uint32)
    for sample in SAMPLES:
        jk = js.path_keys(seed, jnp.asarray(pixels), sample)
        tk = ts.path_keys(seed, torch.as_tensor(pixels.astype(np.int64)), sample)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
        for c in STREAMS:
            jf = js.PcgSampler.fold(jk, c)
            tf = ts.PcgSampler.fold(tk, c)
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf).astype(np.int64))
            for n in (1, 2, 3, 4):
                np.testing.assert_array_equal(
                    ts.PcgSampler.uniform(tf, n).numpy(), np.asarray(js.PcgSampler.uniform(jf, n))
                )


@pytest.mark.parametrize("name", ["path_keys", "fold", "uniform"])
def test_pcg_kernel_ops_take_card_tensors_only(name):
    """Each PCG kernel launch is a dispatcher op with a CUDA kernel alone, so
    the profiler links its launch to the caller's span; CPU tensors never
    reach it."""
    op = f"firefly_pcg::{name}"
    assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(op, "CPU")
    assert getattr(ts, f"_{name}_kernel") is getattr(torch.ops.firefly_pcg, name).default


def test_pcg_calls_on_cpu_tensors_launch_nothing():
    """CPU tensors take the plain version: no kernel is launched or built."""
    before = _build.launch_counts["pcg"]
    keys = ts.path_keys(1234, torch.arange(300), 3)
    for c in (0, 0xA11A, 2**32 - 1):
        for n in (1, 2, 3, 4):
            assert ts.PcgSampler.uniform(ts.PcgSampler.fold(keys, c), n).shape == (300, n)
    assert _build.launch_counts["pcg"] == before


def test_uniform_rejects_more_than_four():
    with pytest.raises(ValueError):
        ts.PcgSampler.uniform(torch.zeros((1, 4), dtype=torch.int64), 5)


def test_warps_match_jax():
    rng = np.random.default_rng(2)
    u = rng.uniform(size=(2048, 2)).astype(np.float32)
    n = rng.normal(size=(2048, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]
    want = np.asarray(js.cosine_sample_hemisphere(jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1])))
    got = ts.cosine_sample_hemisphere(torch.as_tensor(u[:, 0]), torch.as_tensor(u[:, 1])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    for jx, tx in zip(js.make_onb(jnp.asarray(n)), ts.make_onb(torch.as_tensor(n))):
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=2e-6)
    want = np.asarray(js.local_to_world(jnp.asarray(want), jnp.asarray(n)))
    got = ts.local_to_world(torch.as_tensor(got), torch.as_tensor(n)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


_HEADER_SHIM = r"""
#include "pcg.cuh"
using namespace firefly_pcg;
extern "C" void words(const uint32_t* k, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    const Words v = pcg4d(Words{k[4 * i], k[4 * i + 1], k[4 * i + 2], k[4 * i + 3]});
    out[4 * i] = v.x; out[4 * i + 1] = v.y; out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
  }
}
extern "C" void fold(const uint32_t* k, uint32_t c, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = fold_stream(k[4 * i + 3], c);
}
extern "C" void units(const uint32_t* w, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = unit(w[i]);
}
"""


def test_pcg_header_words_equal_plain_route(tmp_path):
    """``csrc/pcg.cuh``, the one definition of the PCG4D words that the
    sampler's kernels (``csrc/pcg.cu``, bit-equal to the plain route on the
    card) and the fused shade step include, built here by the host C++
    compiler: its mixing, fold and draw give the plain int64 route's
    numbers on the stream constants of a render."""
    import ctypes
    import subprocess

    from gpupathtracer_tpu_torch.ops import _build

    src, lib = tmp_path / "shim.cpp", tmp_path / "libshim.so"
    src.write_text(_HEADER_SHIM)
    subprocess.run([_build.HOST_CXX, "-std=c++17", "-O2", "-fPIC", "-shared", "-I", _build.CSRC, "-o", str(lib),
                    str(src)], check=True, capture_output=True, timeout=120)
    shim = ctypes.CDLL(str(lib))
    rng = np.random.default_rng(20)
    keys = rng.integers(0, 2**32, size=(4096, 4), dtype=np.uint64).astype(np.uint32)
    keys[:3] = [[0, 0, 0, 0], [2**32 - 1] * 4, [1234, 7, 3, 0]]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    mixed = np.empty_like(keys)
    shim.words(ptr(keys), ptr(mixed), ctypes.c_long(len(keys)))
    np.testing.assert_array_equal(mixed.astype(np.int64), ts.pcg4d(_u32(keys)).numpy())
    for c in STREAMS + [2**32 - 1]:
        stream = np.empty(len(keys), np.uint32)
        shim.fold(ptr(keys), ctypes.c_uint32(c), ptr(stream), ctypes.c_long(len(keys)))
        np.testing.assert_array_equal(stream.astype(np.int64), ts._fold_plain(_u32(keys), c)[:, 3].numpy())
    draws = np.empty(mixed.shape, np.float32)
    shim.units(ptr(mixed), ptr(draws), ctypes.c_long(mixed.size))
    np.testing.assert_array_equal(draws, ts._uniform_plain(_u32(keys), 4).numpy())
