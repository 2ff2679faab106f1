"""The slot kernel's fold (csrc/slot_intersect.cu: per chunk, the least
accepted t unless the carry or another accepted slot lies in its tie
band, else a replay of the chunk's accepted slots in slot order),
emulated on the CPU (tests/torch_slot_emulate.py), held bitwise equal to
``slot_intersect_plain`` in all four planes: on the scan renderer's
camera, bounce and shadow rays of cornell (one chunk) and of a
600-triangle quad grid (610 triangles with the box: 20 chunks, the last
one holding 2), and on a scene built for ties, whose chunks take both
ways.

The shortcut the source note rules out, splitting a chunk's slots into
groups and merging the groups' partial bests, is shown to differ on the
tie band's counterexample (region 4 of the tie scene: a, b, c with b and
c in one group).
"""

import numpy as np
import pytest
import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.models.camera import generate_rays
from tinyraytracing_tpu_torch.ops.slot_intersect import slot_intersect_plain
from tests.torch_port_util import scan_rays, scene_pair
from tests.torch_slot_emulate import (
    TIE_LAYERS, TIE_WINNERS, emulate, extreme_payload, fast_reciprocal,
    merge_split, tie_rays, tie_scene, tie_shadow_rays,
)

CFG = RenderConfig()
KINDS = ("camera", "bounce", "shadow")


def _planes(org, d):
    return torch.from_numpy(np.ascontiguousarray(
        np.concatenate([org, d], axis=1).T)).contiguous()


def _kind(ts, kind):
    """One of the three kinds of ``scan_rays`` (its thirds, in order)."""
    org, d = scan_rays(ts, n_side=16)
    n = org.shape[0] // 3
    k = KINDS.index(kind)
    return _planes(org[k * n:(k + 1) * n], d[k * n:(k + 1) * n])


def _assert_equal(got, want):
    for name, a, b in zip(("t", "idx", "u", "v"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (
            name, int((a != b).sum()))


@pytest.fixture(scope="module")
def ties():
    scene, cam = tie_scene(device="cpu")
    o, d = generate_rays(cam, (0, 9), "cpu")
    camera = torch.cat([o.T, d.T]).contiguous()
    return scene, {"tied": tie_rays(device="cpu"), "camera": camera,
                   "shadow": tie_shadow_rays(scene, 2048, device="cpu")}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["cornell", "grid600"])
def test_fold_emulation_equals_plain(name, kind):
    _, ts = scene_pair(name)
    P, n_chunks = ts.slot_payload
    T = ts.num_triangles
    assert n_chunks == (1 if name == "cornell" else 20) == -(-T // 32)
    assert name == "cornell" or T % 32 > 0              # a partial chunk
    rays = _kind(ts, kind)
    want = slot_intersect_plain(P, T, rays, CFG)
    assert int((want[0] < 3.0e38).sum()) > rays.shape[1] // 4
    stats = {}
    _assert_equal(emulate(P, T, rays, CFG, stats=stats), want)
    assert stats["fast"] > 0


def test_tie_rays_hit_the_winners(ties):
    """Every region's rays hit the slot the repl rule picks (TIE_WINNERS),
    and the shadow rays hit every region with a light."""
    scene, rays = ties
    P, n_chunks = scene.slot_payload
    assert n_chunks == 2 and scene.num_triangles == 40
    want = slot_intersect_plain(P, scene.num_triangles, rays["tied"], CFG)
    per = rays["tied"].shape[1] // len(TIE_LAYERS)
    for reg, slot in TIE_WINNERS.items():
        hit = want[1][reg * per:(reg + 1) * per]
        assert (hit == slot).all(), (reg, hit.unique().tolist())
    want = slot_intersect_plain(P, scene.num_triangles, rays["shadow"], CFG)
    assert bool((want[0] < 3.0e38).all())
    lit = {TIE_WINNERS[r] for r, ls in TIE_LAYERS.items()
           if any(em for _, _, em in ls)}
    assert set(want[1].unique().tolist()) == lit


@pytest.mark.parametrize("kind", ["tied", "camera", "shadow"])
def test_fold_emulation_equals_plain_on_ties(ties, kind):
    """The emulated fold equals the plain one on the tie scene's rays; the
    tied chunks are replayed, the others take the least t."""
    scene, rays = ties
    P, _ = scene.slot_payload
    T = scene.num_triangles
    want = slot_intersect_plain(P, T, rays[kind], CFG)
    assert int((want[0] < 3.0e38).sum()) > rays[kind].shape[1] // 4
    stats = {}
    _assert_equal(emulate(P, T, rays[kind], CFG, stats=stats), want)
    assert stats["replayed"] > 0
    assert stats["fast"] > 0 or kind == "shadow"  # every light lies in a tie


@pytest.mark.parametrize("name", ["cornell", "grid600"])
def test_fold_emulation_equals_plain_off_the_fast_reciprocal(name):
    """Slots whose ldw lies outside the fast reciprocal's range (scaled w
    rows: denormal, huge or overflowed) send their chunks to the replay,
    which tests them with the exact reciprocal: still bitwise plain."""
    _, ts = scene_pair(name)
    P = extreme_payload(ts.slot_payload[0])
    rays = _planes(*scan_rays(ts, n_side=16))
    c = P[1:3].reshape(2, -1, 4, 32)[[0, 0, 1], :, [2, 3, 0]]   # cx cy cz
    ldw = sum(rays[3 + k, :, None] * c[k].reshape(1, -1) for k in range(3))
    assert bool(((ldw != 0) & ~fast_reciprocal(ldw)).any())
    want = slot_intersect_plain(P, ts.num_triangles, rays, CFG)
    assert int((want[0] < 3.0e38).sum()) > 0
    stats = {}
    _assert_equal(emulate(P, ts.num_triangles, rays, CFG, stats=stats), want)
    assert stats["replayed"] > 0


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_partial_merge_differs_on_the_counterexample(ties, parts):
    """Region 4: in slot order a, b, c end at c; a group holding b and c
    folds them to b, and b merged onto a keeps a."""
    scene, rays = ties
    P, _ = scene.slot_payload
    T = scene.num_triangles
    want = slot_intersect_plain(P, T, rays["tied"], CFG)
    got = merge_split(P, T, rays["tied"], CFG, parts)
    per = rays["tied"].shape[1] // len(TIE_LAYERS)
    reg = slice(4 * per, 5 * per)
    a, b, c = (s for s, _, _ in TIE_LAYERS[4])
    assert b % parts == c % parts != a % parts
    assert (want[1][reg] == c).all()
    assert (got[1][reg] == a).all()
