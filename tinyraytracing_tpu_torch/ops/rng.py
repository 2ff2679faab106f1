"""Planar counter-based RNG: Threefry-2x32-20 on component planes, bit for
bit the stream of ``tinyraytracing_tpu/ops/rng.py``.

PyTorch's uint32 support is partial (no shifts or adds on every backend),
so words are carried as int64 tensors holding values in [0, 2^32) and
every add or shift is masked back to 32 bits.

Stream layout (as in the JAX package):
- path key  = TF(master_key, (path_id, PATH_TAG))
- draw pair = TF(path_key, (bounce, draw_pair_index))
  giving 2 uniforms per block; uniform = (bits >> 8) * 2^-24 in [0, 1).

``split``, ``fold_in``, ``uniform`` and ``randint`` reproduce
``jax.random``'s bits for a raw (2,) threefry key under
``jax_threefry_partitionable`` (the default since JAX 0.5):
``fold_in(k, d) = TF(k, (0, d))``, ``split(k)[j] = TF(k, (0, j))``, and
flat element i of the 32-bit words of ``k`` is ``y0 ^ y1`` with
(y0, y1) = TF(k, (0, i)); ``uniform`` scales ``(y0 ^ y1) >> 9`` by 2^-23.
Keys are pairs of Python ints, derived on the host: they cost no device
launch. ``fold_in_planes`` folds a plane of data words into one key on
the device (``jax.vmap(lambda t: fold_in(key, t))``).

``path_keys`` and ``bounce_uniforms``, which the render loops and the
differentiable path call on every lane every iteration, launch the
kernels of ``csrc/rng.cu`` on a CUDA tensor (one launch a call, the words
in uint32 registers: the fusion XLA makes of the same chain) and run
their plain versions, ``path_keys_plain`` and ``bounce_uniforms_plain``
(the int64 chain), on a CPU tensor; kernel and plain version agree
bitwise. ``fold_in_planes`` (``render_regen``'s camera jitter) is the
int64 chain on every device.
"""

from __future__ import annotations

import ctypes

import torch

from tinyraytracing_tpu_torch.utils import spans

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
PATH_TAG = 0x9E3779B9
MAX_DRAWS = 256          # csrc/rng.cu MAX_DRAWS: planes a draws launch carries


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32-20 (5 groups of 4 rounds, a key injection after each
    group). Arguments are int64 tensors (or Python ints) of 32-bit words,
    broadcastable; returns a pair of int64 tensors of 32-bit words."""
    x0 = (c0 + k0) & _M
    x1 = (c1 + k1) & _M
    ks2 = k0 ^ k1 ^ _PARITY
    sched = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    rounds = (_ROT[0], _ROT[1], _ROT[0], _ROT[1], _ROT[0])
    for block in range(5):
        for r in rounds[block]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        a, b = sched[block]
        x0 = (x0 + a) & _M
        x1 = (x1 + b + (block + 1)) & _M
    return x0, x1


def bits_to_uniform(bits):
    """32-bit words -> float32 uniform in [0, 1) with 24-bit resolution."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def master_key_data(seed: int) -> tuple[int, int]:
    """The (2,) key words of ``jax.random.PRNGKey(seed)`` (threefry
    default): (0, seed) for 0 <= seed < 2^32."""
    seed = int(seed)
    if not 0 <= seed <= _M:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return (0, seed)


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in`` on a (k0, k1) key of Python ints."""
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data) & _M)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split``: ``num`` keys, key j = ``fold_in(key, j)``."""
    return [fold_in(key, j) for j in range(num)]


def fold_in_planes(key, data):
    """``fold_in(key, t)`` for every word t of the integer tensor ``data``
    (taken modulo 2^32): the two key-word planes, int64."""
    return threefry2x32(int(key[0]), int(key[1]), 0, data.to(torch.int64) & _M)


def _bits(key, shape, device):
    """``jax.random.bits(key, shape, uint32)`` as int64 words."""
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(int(key[0]), int(key[1]), 0, i)
    return (y0 ^ y1).reshape(tuple(shape))


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1) on ``device``."""
    return (_bits(key, shape, device) >> 9).to(torch.float32) * (1.0 / (1 << 23))


def randint(key, shape, minval: int, maxval: int, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 bounds
    (``jax/_src/random.py::_randint``), as int64: the words of the two
    halves of ``split(key)`` reduced into the span as uint32 arithmetic
    that wraps (emulated in int64, masked to 32 bits after every product
    and sum). An empty range gives ``minval``."""
    lo32, hi32 = -(1 << 31), (1 << 31) - 1
    if not (lo32 <= minval <= hi32 and lo32 <= maxval <= hi32):
        raise ValueError(f"randint bounds must be int32, got {minval}, {maxval}")
    span = max(maxval - minval, 1)
    k1, k2 = split(key)
    hi, lo = _bits(k1, shape, device), _bits(k2, shape, device)
    mult = ((((1 << 16) % span) ** 2) & _M) % span
    off = (((hi % span) * mult) & _M) + lo % span
    return minval + (off & _M) % span


def path_keys_plain(key_data, path_id):
    """``path_keys`` in stock tensor ops on any device: the int64 chain."""
    pid = path_id.to(torch.int64) & _M
    return threefry2x32(int(key_data[0]), int(key_data[1]), pid, PATH_TAG)


def bounce_uniforms_plain(k0, k1, bounce, n):
    """``bounce_uniforms`` in stock tensor ops on any device: the int64
    chain, a block of two uniforms at a time."""
    b = bounce.to(torch.int64) & _M
    out = []
    for blk in range((n + 1) // 2):
        r0, r1 = threefry2x32(k0, k1, b, blk)
        out.append(bits_to_uniform(r0))
        out.append(bits_to_uniform(r1))
    return out[:n]


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers (csrc/rng.cu)
# ---------------------------------------------------------------------------

def _lib():
    from tinyraytracing_tpu_torch.ops.kernels import library

    lib = library("rng.cu")
    if not getattr(lib, "_trt_typed", False):
        P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
        lib.trt_threefry_draws.argtypes = [P, P, P, L, ctypes.POINTER(P), I, I, P]
        lib.trt_threefry_draws.restype = ctypes.c_int
        lib.trt_threefry_path_keys.argtypes = [P, P, P, U, U, I, P]
        lib.trt_threefry_path_keys.restype = ctypes.c_int
        lib._trt_typed = True
    return lib


def _words(name, x, dev):
    """``x`` as the kernels read it: contiguous int64 on ``dev``."""
    if x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous int64, got {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (not contiguous)'}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.numel() >= 2**31:
        raise ValueError(f"{name} has too many lanes for int32 ids")


def bounce_uniforms_kernel(k0, k1, bounce, n):
    """Launch ``threefry_draws`` on PyTorch's current stream: what
    ``bounce_uniforms_plain`` returns, bitwise. ``k0``, ``k1``: int64 key
    planes of one shape; ``bounce``: int64 of that shape, or 0-d (one
    bounce for every lane). One launch, ``n`` planes from ``torch.empty``,
    nothing read back to the host. Raises on a CPU tensor, a bad input or
    a failed launch."""
    if not k0.is_cuda:
        raise ValueError("bounce_uniforms_kernel needs CUDA tensors")
    dev = k0.device
    for name, x in (("k0", k0), ("k1", k1), ("bounce", bounce)):
        _words(name, x, dev)
    if k1.shape != k0.shape or bounce.dim() and bounce.shape != k0.shape:
        raise ValueError(f"k0 {tuple(k0.shape)}, k1 {tuple(k1.shape)} and bounce "
                         f"{tuple(bounce.shape)} must share a shape (bounce may be 0-d)")
    if not 1 <= n <= MAX_DRAWS:
        raise ValueError(f"n must be in [1, {MAX_DRAWS}], got {n}")
    out = [torch.empty(k0.shape, dtype=torch.float32, device=dev) for _ in range(n)]
    R = k0.numel()
    if R == 0:
        return out
    ptrs = (ctypes.c_void_p * n)(*(x.data_ptr() for x in out))
    with torch.cuda.device(dev):
        err = _lib().trt_threefry_draws(
            k0.data_ptr(), k1.data_ptr(), bounce.data_ptr(),
            int(bounce.dim() > 0), ptrs, n, R,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_draws kernel launch failed: cudaError {err}")
    spans.count("launches.threefry_draws")
    return out


def path_keys_kernel(key_data, path_id):
    """Launch ``threefry_path_keys`` on PyTorch's current stream: what
    ``path_keys_plain`` returns, bitwise, for int64 ``path_id``. One
    launch, two planes from ``torch.empty``, nothing read back to the
    host. Raises on a CPU tensor, a bad input or a failed launch."""
    if not path_id.is_cuda:
        raise ValueError("path_keys_kernel needs CUDA tensors")
    dev = path_id.device
    _words("path_id", path_id, dev)
    k0, k1 = (torch.empty(path_id.shape, dtype=torch.int64, device=dev)
              for _ in range(2))
    R = path_id.numel()
    if R == 0:
        return k0, k1
    with torch.cuda.device(dev):
        err = _lib().trt_threefry_path_keys(
            path_id.data_ptr(), k0.data_ptr(), k1.data_ptr(),
            int(key_data[0]) & _M, int(key_data[1]) & _M, R,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_path_keys kernel launch failed: cudaError {err}")
    spans.count("launches.threefry_path_keys")
    return k0, k1


def path_keys(key_data, path_id):
    """Per-path key planes (k0, k1) from the master key words and (R,)
    integer path ids (taken modulo 2^32, like the JAX uint32 cast): the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if path_id.is_cuda:
        return path_keys_kernel(key_data, path_id)
    if path_id.device.type == "cpu":
        return path_keys_plain(key_data, path_id)
    raise ValueError(f"no path_keys implementation for device {path_id.device}")


def bounce_uniforms(k0, k1, bounce, n):
    """``n`` float32 (R,) uniform planes for this (path, bounce): a pure
    function of (path key, bounce, draw index). The kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if k0.is_cuda:
        return bounce_uniforms_kernel(k0, k1, bounce, n)
    if k0.device.type == "cpu":
        return bounce_uniforms_plain(k0, k1, bounce, n)
    raise ValueError(f"no bounce_uniforms implementation for device {k0.device}")
