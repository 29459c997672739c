"""The port's compaction permutations equal the JAX package's exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.ops import compaction as jc
from gpupathtracer_tpu_torch.ops import compaction as tc


@pytest.mark.parametrize("share", [0.0, 0.03, 0.5, 0.97, 1.0])
def test_partition_alive_equal_jax(share):
    rng = np.random.default_rng(int(share * 100))
    alive = rng.uniform(size=3001) < share
    jperm, jinv = jc.partition_alive(jnp.asarray(alive))
    tperm, tinv = tc.partition_alive(torch.as_tensor(alive))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))


def test_compact_rays_equal_jax():
    rng = np.random.default_rng(9)
    o = rng.normal(size=(777, 3)).astype(np.float32)
    d = rng.normal(size=(777, 3)).astype(np.float32)
    alive = rng.uniform(size=777) < 0.4
    jo, jd, jinv = jc.compact_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive))
    to, td, tinv = tc.compact_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(alive))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(to.numpy()[tinv.numpy()][alive], o[alive])


@pytest.mark.parametrize("share", [0.0, 0.3, 0.9, 1.0])
@pytest.mark.parametrize("key_mode", ["dir", "origin"])
def test_compact_rays_coherent_equal_jax(key_mode, share):
    """Compaction with the coherence sort: the same permutation, rays and
    parked lanes as the JAX package's, for both key layouts."""
    rng = np.random.default_rng(int(share * 10) + 7)
    o = (rng.normal(size=(1500, 3)) * 3).astype(np.float32)
    d = rng.normal(size=(1500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.uniform(size=1500) < share
    jo, jd, jinv = jc.compact_rays_coherent(jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive), key_mode=key_mode)
    to, td, tinv = tc.compact_rays_coherent(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(alive),
                                            key_mode=key_mode)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(to.numpy()[tinv.numpy()][alive], o[alive])
    assert (tinv.numpy()[alive] < alive.sum()).all()  # live lanes first
