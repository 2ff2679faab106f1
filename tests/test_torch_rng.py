"""tinyraytracing_tpu_torch.ops.rng against tinyraytracing_tpu.ops.rng:
the planar threefry stream must be bit for bit the JAX package's.

The kernels of ``csrc/rng.cu`` run only on the card. On the CPU a numpy
``uint32`` transcription of their thread program
(``tests/torch_rng_emulate.py``) is held bitwise to the plain int64 chain,
on random words and on words at and above 2^31, at 2^32 - 1 and past 32
bits; its constants are read back out of the source; and the wrappers
take the plain versions for CPU tensors.

On the card (marked ``cuda``; they skip elsewhere; run them there with
``python -m pytest tests/test_torch_rng.py -q --noconftest -m cuda``):
both kernels bitwise their plain versions for n in {1, 2, 5, 9, 13} and
R in {0, 1, 127, 128, 4,097, 262,144}, bounce as an (R,) plane and as a
0-d tensor, with one launch a call and a storage of its own for each
draw; no wrapper call synchronizes; bad inputs raise. This file imports
JAX only inside the tests that compare with the JAX package, so the card
tests run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from tinyraytracing_tpu_torch.ops import rng as trng
from tinyraytracing_tpu_torch.utils import spans
# by its own name: the card's machine may have another package named tests
import torch_rng_emulate as emu

M32 = 2**32


def _jax():
    """(jax, jax.numpy, the JAX package's rng)."""
    import jax
    import jax.numpy as jnp

    from tinyraytracing_tpu.ops import rng as jrng

    return jax, jnp, jrng


def _u32(rng, n):
    return rng.integers(0, M32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def test_threefry_bits_equal_jax_on_random_counters():
    _, jnp, jrng = _jax()
    rng = np.random.default_rng(11)
    k0, k1, c0, c1 = (_u32(rng, 4096) for _ in range(4))
    j0, j1 = jrng.threefry2x32(*(jnp.asarray(x) for x in (k0, k1, c0, c1)))
    p0, p1 = trng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    np.testing.assert_array_equal(p0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(j1).astype(np.int64))


def test_threefry_pinned_vectors():
    from tests.test_utils import _THREEFRY_PINNED

    k0 = [0x12345678, 0, 0xFFFFFFFF]
    k1 = [0x9ABCDEF0, 0, 0xFFFFFFFF]
    c0 = [0, 1, 0xDEADBEEF]
    c1 = [0, 2, 0xCAFEBABE]
    r0, r1 = trng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    got = np.stack([r0.numpy(), r1.numpy()])
    np.testing.assert_array_equal(got, np.asarray(_THREEFRY_PINNED, np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, 2**32 - 1])
def test_master_key_data_is_prngkey(seed):
    jax, _, _ = _jax()
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert trng.master_key_data(seed) == tuple(int(x) for x in want)
    with pytest.raises(ValueError):
        trng.master_key_data(-1)


def test_path_keys_and_bounce_uniforms_equal_jax():
    _, jnp, jrng = _jax()
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
    jax, _, _ = _jax()
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
    jax, jnp, _ = _jax()
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
    tkey = trng.fold_in(trng.master_key_data(seed), 4)
    want = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
    got = trng.uniform(tkey, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_fold_in_planes_equals_jax_vmap():
    """The regeneration oracles' camera jitter: ``fold_in(key, t)`` over a
    plane of path ids, as ``jax.vmap`` computes it."""
    jax, jnp, _ = _jax()
    rng = np.random.default_rng(12)
    words = _u32(rng, 2)
    data = rng.integers(0, 2**31, 4096, dtype=np.int64)
    key = jnp.asarray(words)
    want = np.asarray(jax.random.key_data(jax.vmap(
        lambda t: jax.random.fold_in(key, t))(jnp.asarray(data, jnp.int32))))
    w0, w1 = trng.fold_in_planes(tuple(int(w) for w in words), torch.from_numpy(data))
    np.testing.assert_array_equal(w0.numpy(), want[:, 0].astype(np.int64))
    np.testing.assert_array_equal(w1.numpy(), want[:, 1].astype(np.int64))


# ---------------------------------------------------------------------------
# the kernels' thread program (tests/torch_rng_emulate.py), on the CPU
# ---------------------------------------------------------------------------

# words a lane may carry: at and above 2^31, at 2^32 - 1, and int64 values
# past 32 bits, which every route takes modulo 2^32
PINNED = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1,
                   2**32, 2**32 + 5, 2**40 + 2**31, -1, -2**31], np.int64)


def _lanes(seed, R):
    """(k0, k1, bounce) int64 planes of R lanes: the pinned words in turn
    in the first lanes (each plane rolled, so they meet in several
    combinations), random 32-bit words after them; bounces from 0 to 17
    and the pinned words."""
    rng = np.random.default_rng(seed)
    k0, k1 = (rng.integers(0, M32, R, dtype=np.int64) for _ in range(2))
    bounce = rng.integers(0, 18, R, dtype=np.int64)
    m = min(R, len(PINNED))
    for x, roll in ((k0, 0), (k1, 3), (bounce, 7)):
        x[:m] = np.roll(PINNED, roll)[:m]
    return k0, k1, bounce


def _bounce(bounce, kind, pick=3):
    """The bounce as a plane, or as one pinned word (0-d) for every lane."""
    return bounce if kind == "plane" else np.asarray(PINNED[pick % len(PINNED)])


@pytest.mark.parametrize("kind", ["plane", "0-d"])
@pytest.mark.parametrize("n", [1, 2, 5, 9, 13])
def test_emulation_bitwise_equal_plain_chain(n, kind):
    """``threefry_draws``' thread program against ``bounce_uniforms_plain``
    (the int64 chain), and ``threefry_path_keys``' against
    ``path_keys_plain``, on random and pinned words."""
    k0, k1, bounce = _lanes(100 + n, 4097)
    b = _bounce(bounce, kind, n)
    want = trng.bounce_uniforms_plain(torch.from_numpy(k0), torch.from_numpy(k1),
                                      torch.from_numpy(b), n)
    got = emu.draws(k0, k1, b, n)
    assert len(got) == n
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g.view(np.int32), w.numpy().view(np.int32))
    for key in ((0, 1234), (2**31, 2**32 - 1), (2**32 - 1, 0), (k0[9], k1[5])):
        want = trng.path_keys_plain(key, torch.from_numpy(bounce if kind == "plane" else k0))
        got = emu.path_keys(key, bounce if kind == "plane" else k0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


def test_emulation_constants_are_the_kernels():
    """The emulation's rotations, key injections, constants and launch
    capacity are ``csrc/rng.cu``'s, and the wrappers' capacity too."""
    from pathlib import Path

    text = (Path(trng.__file__).parents[1] / "csrc" / "rng.cu").read_text()
    for name, value in (("THREADS", emu.THREADS), ("MAX_DRAWS", emu.MAX_DRAWS)):
        assert f"constexpr int {name} = {value};" in text, name
    assert emu.MAX_DRAWS == trng.MAX_DRAWS
    for name, value in (("PARITY", emu.PARITY), ("PATH_TAG", emu.PATH_TAG)):
        assert f"constexpr uint32_t {name} = 0x{value:08X}u;" in text, name
    assert (emu.PARITY, emu.PATH_TAG, emu.ROT) == (trng._PARITY, trng.PATH_TAG, trng._ROT)
    # the round order: threefry's body, line by line, in this order
    body = text[text.index("__device__ __forceinline__ void threefry("):]
    body = [line.strip() for line in body[:body.index("\n}\n")].splitlines()]
    assert [line for line in body if line.startswith(("x0 +=", "group<"))] \
        == emu.source_lines()
    assert "x0 += x1; x1 = rotl(x1, R0) ^ x0;" in text
    assert "return __funnelshift_l(x, x, r);" in text
    assert "return __uint2float_rn(bits >> 8) * 0x1p-24f;" in text
    # the counters: (bounce, j / 2) for the draws, (path id, PATH_TAG) for keys
    assert "uint32_t x0 = b, x1 = (uint32_t)(j / 2);" in text
    assert "uint32_t x0 = (uint32_t)path_id[i], x1 = PATH_TAG;" in text


@pytest.mark.parametrize("kind", ["plane", "0-d"])
def test_cpu_tensors_take_the_plain_route(kind):
    """On CPU tensors the wrappers are the plain versions, bitwise, with no
    launch counted; int32 ids and bounces still serve there; the kernel
    wrappers refuse CPU tensors."""
    k0, k1, bounce = (torch.from_numpy(x) for x in _lanes(7, 300))
    b = torch.from_numpy(_bounce(bounce.numpy(), kind))
    with spans.recording() as rec:
        got = trng.bounce_uniforms(k0, k1, b, 9)
        keys = trng.path_keys((5, 2**32 - 1), bounce)
        keys32 = trng.path_keys((5, 2**32 - 1), bounce.to(torch.int32))
        got32 = trng.bounce_uniforms(k0, k1, b.to(torch.int32), 9)
    assert not any(k.startswith("launches.threefry") for k in rec.counts)
    want = trng.bounce_uniforms_plain(k0, k1, b, 9)
    for g, g32, w, e in zip(got, got32, want, emu.draws(k0, k1, b, 9)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.equal(g32.view(torch.int32), w.view(torch.int32))
        np.testing.assert_array_equal(g.numpy().view(np.int32), e.view(np.int32))
    for a, a32, w in zip(keys, keys32, trng.path_keys_plain((5, 2**32 - 1), bounce)):
        assert a.dtype == torch.int64 and torch.equal(a, w) and torch.equal(a32, w)
    with pytest.raises(ValueError, match="needs CUDA"):
        trng.bounce_uniforms_kernel(k0, k1, b, 9)
    with pytest.raises(ValueError, match="needs CUDA"):
        trng.path_keys_kernel((5, 6), bounce)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plane", "0-d"])
@pytest.mark.parametrize("R", [0, 1, 127, 128, 4097, 262_144])
@pytest.mark.parametrize("n", [1, 2, 5, 9, 13])
def test_kernels_bitwise_equal_plain(n, R, kind, device):
    k0, k1, bounce = (torch.from_numpy(x).to(device) for x in _lanes(R + n, R))
    b = torch.from_numpy(_bounce(bounce.cpu().numpy(), kind, n)).to(device)
    with spans.recording() as rec:
        got = trng.bounce_uniforms(k0, k1, b, n)
        keys = trng.path_keys((2**31 + n, 2**32 - 1), k1)
    launched = 1 if R else 0
    assert rec.counts.get("launches.threefry_draws", 0) == launched
    assert rec.counts.get("launches.threefry_path_keys", 0) == launched
    want = trng.bounce_uniforms_plain(k0, k1, b, n)
    assert len(got) == n
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (R,) and g.device == k0.device
        assert torch.equal(_bits(g), _bits(w))
    # each draw its own allocation, no view of a shared block
    ptrs = {g.untyped_storage().data_ptr() for g in got}
    assert R == 0 or len(ptrs) == n
    assert all(g.untyped_storage().nbytes() == 4 * R for g in got)
    for a, w in zip(keys, trng.path_keys_plain((2**31 + n, 2**32 - 1), k1)):
        assert a.dtype == torch.int64 and torch.equal(a.cpu(), w.cpu())


@pytest.mark.cuda
def test_wrappers_never_synchronize(device):
    """No wrapper call reads anything back to the host."""
    k0, k1, bounce = (torch.from_numpy(x).to(device) for x in _lanes(5, 262_144))
    b0 = torch.tensor(3, device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trng.bounce_uniforms(k0, k1, bounce, 9)
        trng.bounce_uniforms(k0, k1, b0, 9)
        trng.path_keys((1, 2), bounce)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_bad_inputs_raise(device):
    """Non-int64 or non-contiguous words, shapes that do not match, n out
    of [1, MAX_DRAWS] and tensors on two devices raise, and launch nothing."""
    k0, k1, bounce = (torch.from_numpy(x).to(device) for x in _lanes(6, 1024))
    strided = torch.from_numpy(_lanes(7, 2048)[0]).to(device)[::2]
    draws = trng.bounce_uniforms
    with spans.recording() as rec:
        for call in (lambda: draws(k0.int(), k1, bounce, 9),
                     lambda: draws(k0, k1.int(), bounce, 9),
                     lambda: draws(k0, k1, bounce.int(), 9),
                     lambda: draws(strided, k1, bounce, 9),
                     lambda: draws(k0, strided, bounce, 9),
                     lambda: draws(k0, k1, strided, 9),
                     lambda: draws(k0, k1, bounce[:7], 9),
                     lambda: draws(k0, k1[:7], bounce, 9),
                     lambda: draws(k0, k1, bounce.cpu(), 9),
                     lambda: draws(k0, k1, bounce, 0),
                     lambda: draws(k0, k1, bounce, trng.MAX_DRAWS + 1),
                     lambda: trng.path_keys((1, 2), bounce.int()),
                     lambda: trng.path_keys((1, 2), strided)):
            with pytest.raises(ValueError):
                call()
    assert not any(k.startswith("launches.threefry") for k in rec.counts)
    # the capacity itself launches
    assert len(draws(k0, k1, bounce, trng.MAX_DRAWS)) == trng.MAX_DRAWS
