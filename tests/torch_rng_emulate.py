"""A numpy ``uint32`` transcription of ``tinyraytracing_tpu_torch/csrc/rng.cu``,
for the CPU tests (the kernels run only on the card).

It follows the kernels' thread program lane by lane, vectorised over the
lanes: each lane reads its int64 words and keeps their low 32 bits, runs
Threefry-2x32-20 as ``threefry`` in the source does (the key words and
their parity word, the counter plus the key, five groups of four rounds,
each round an add, a rotate and an xor, the rotations ``ROT[g % 2]``, and
after group g the injection ``INJECT[g]`` with g + 1 added to the second
word), and writes what the kernel writes: uniform j of ``threefry_draws``
from block j // 2 of the counter (bounce, j // 2), the first word for even
j and the second for odd; the two key words of ``threefry_path_keys``
from the counter (path id, ``PATH_TAG``). numpy's uint32 arithmetic wraps
as the card's does. The constants are the source's (the CPU tests read
them back out of it).
"""

from __future__ import annotations

import numpy as np

THREADS = 256                  # csrc/rng.cu THREADS
MAX_DRAWS = 256                # MAX_DRAWS
PARITY = 0x1BD11BDA
PATH_TAG = 0x9E3779B9
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# the key words added after group g: (to x0, to x1); x1 also gets g + 1
INJECT = (("k1", "k2"), ("k2", "k0"), ("k0", "k1"), ("k1", "k2"), ("k2", "k0"))


def words(x) -> np.ndarray:
    """The low 32 bits of int64 words, as a lane reads them (``(uint32_t)``)."""
    return np.atleast_1d(np.asarray(x, np.int64)).astype(np.uint32)


def rotl(x: np.ndarray, r: int) -> np.ndarray:
    """``__funnelshift_l(x, x, r)`` for 0 < r < 32."""
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry(k0, k1, x0, x1):
    """The counter (x0, x1) under the key (k0, k1), uint32 arrays that
    broadcast: the kernels' ``threefry``."""
    ks = {"k0": k0, "k1": k1, "k2": k0 ^ k1 ^ np.uint32(PARITY)}
    x0, x1 = x0 + k0, x1 + k1
    for g in range(5):
        for r in ROT[g % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        a, b = INJECT[g]
        x0 = x0 + ks[a]
        x1 = x1 + (ks[b] + np.uint32(g + 1))
    return x0, x1


def uniform(bits: np.ndarray) -> np.ndarray:
    """``__uint2float_rn(bits >> 8) * 0x1p-24f``."""
    return (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def draws(k0, k1, bounce, n: int) -> list[np.ndarray]:
    """``threefry_draws``: n float32 planes from the int64 key planes and
    the bounce (a plane, or one word that every lane reads: stride 0)."""
    k0, k1 = words(k0), words(k1)
    b = np.broadcast_to(words(bounce), k0.shape)
    out = [None] * n
    for j in range(0, n, 2):
        x0, x1 = threefry(k0, k1, b, np.full(k0.shape, j // 2, np.uint32))
        out[j] = uniform(x0)
        if j + 1 < n:
            out[j + 1] = uniform(x1)
    return out


def path_keys(key, path_id) -> tuple[np.ndarray, np.ndarray]:
    """``threefry_path_keys``: the two int64 key planes of the path ids
    under the master key words ``key`` (the launch's arguments)."""
    pid = words(path_id)
    k0 = np.full(pid.shape, int(key[0]) & 0xFFFFFFFF, np.uint32)
    k1 = np.full(pid.shape, int(key[1]) & 0xFFFFFFFF, np.uint32)
    x0, x1 = threefry(k0, k1, pid, np.full(pid.shape, PATH_TAG, np.uint32))
    return x0.astype(np.int64), x1.astype(np.int64)


def source_lines() -> list[str]:
    """The lines of the source's ``threefry`` that the tables above
    imply: the counter plus the key, then each group with its injection."""
    lines = ["x0 += k0; x1 += k1;"]
    for g in range(5):
        a, b = INJECT[g]
        rot = ", ".join(str(r) for r in ROT[g % 2])
        lines.append(f"group<{rot}>(x0, x1); x0 += {a}; x1 += {b} + {g + 1}u;")
    return lines
