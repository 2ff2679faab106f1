"""tinyraytracing_tpu_torch.ops.rng against tinyraytracing_tpu.ops.rng:
the planar threefry stream must be bit for bit the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracing_tpu.ops import rng as jrng
from tinyraytracing_tpu_torch.ops import rng as trng
from tests.test_utils import _THREEFRY_PINNED

M32 = 2**32


def _u32(rng, n):
    return rng.integers(0, M32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def test_threefry_bits_equal_jax_on_random_counters():
    rng = np.random.default_rng(11)
    k0, k1, c0, c1 = (_u32(rng, 4096) for _ in range(4))
    j0, j1 = jrng.threefry2x32(*(jnp.asarray(x) for x in (k0, k1, c0, c1)))
    p0, p1 = trng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    np.testing.assert_array_equal(p0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(j1).astype(np.int64))


def test_threefry_pinned_vectors():
    k0 = [0x12345678, 0, 0xFFFFFFFF]
    k1 = [0x9ABCDEF0, 0, 0xFFFFFFFF]
    c0 = [0, 1, 0xDEADBEEF]
    c1 = [0, 2, 0xCAFEBABE]
    r0, r1 = trng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    got = np.stack([r0.numpy(), r1.numpy()])
    np.testing.assert_array_equal(got, np.asarray(_THREEFRY_PINNED, np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, 2**32 - 1])
def test_master_key_data_is_prngkey(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert trng.master_key_data(seed) == tuple(int(x) for x in want)
    with pytest.raises(ValueError):
        trng.master_key_data(-1)


def test_path_keys_and_bounce_uniforms_equal_jax():
    rng = np.random.default_rng(12)
    key = trng.master_key_data(1234)
    n = 2048
    pid = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    bounce = rng.integers(0, 16, n).astype(np.int32)
    jk = jrng.path_keys(jnp.asarray(key, jnp.uint32), jnp.asarray(pid))
    tk = trng.path_keys(key, torch.from_numpy(pid))
    for a, b in zip(jk, tk):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(np.int64))
    ju = jrng.bounce_uniforms(jk[0], jk[1], jnp.asarray(bounce), 9)
    tu = trng.bounce_uniforms(tk[0], tk[1], torch.from_numpy(bounce), 9)
    assert len(tu) == 9
    for a, b in zip(ju, tu):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the camera jitter draws straight from the key words
    np.testing.assert_array_equal(trng.bits_to_uniform(tk[0]).numpy(),
                                  np.asarray(jrng.bits_to_uniform(jk[0])))


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**32 - 1])
def test_split_and_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = trng.master_key_data(seed)
    want = np.asarray(jax.random.split(key)).astype(np.int64)
    got = np.asarray(trng.split(tkey), np.int64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(trng.split(tkey, 5), np.int64),
        np.asarray(jax.random.split(key, 5)).astype(np.int64))
    for data in (0, 1, 15, 2**31 + 7):
        np.testing.assert_array_equal(
            np.asarray(trng.fold_in(tkey, data), np.int64),
            np.asarray(jax.random.fold_in(key, data)).astype(np.int64))
    # the scan renderer's chains: fold_in(fold_in(key, depth), purpose)
    k2 = jax.random.fold_in(jax.random.fold_in(key, 9), 1)
    assert trng.fold_in(trng.fold_in(tkey, 9), 1) == tuple(
        int(x) for x in np.asarray(k2))


@pytest.mark.parametrize("shape", [(2, 16 * 12), (300, 1, 4), (96, 3, 4),
                                   (5, 777)])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_uniform_equals_jax(seed, shape):
    """The camera jitter (2, W*H), NEE (R, L, 4) and BSDF (5, R) draws."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
    tkey = trng.fold_in(trng.master_key_data(seed), 4)
    want = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
    got = trng.uniform(tkey, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
