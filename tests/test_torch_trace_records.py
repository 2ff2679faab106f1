"""The trace kernels' layout (``ops.trace.trace_records``,
``Scene.trace_records``) and their two-loop walk, on the CPU.

(a) The records decode back to the packed tree the JAX package built: each
child record holds its WN lanes bitwise, a leaf child's link is the first
of its slot records, an interior child's link the number of children of
its wide node, the shading records equal PS rows 4-7 at the occupied
slots, and the slot test records are ``Scene.bvh_records.slot`` itself.

(b) A per-ray emulation of the CUDA kernel's walk over those records
(``tests/torch_trace_emulate.py``: csrc/trace.cu operation for operation,
vectorised over rays, with the warp's vote made over groups of ``warp``
consecutive rays)
is bitwise equal to ``trace_plain``, the one-leaf-at-a-time walk over
WN / PS, for the three queries (closest hit with and without attributes,
occlusion) on camera, bounce, shadow-direction and bounded shadow rays, in
both walk orders. The preorder walk holds up to two leaves, as the kernel
does, with the vote over warps of 32 rays, and up to four with no vote at
all (every lane walks on until it holds four leaves or its walk ends):
the exactness argument of the source note must hold whatever the vote
and the number held. The near-first walk holds
one leaf at a time, as the kernel does. Scenes: quad_grid(6000) at leaf 8
and 32, and cornell.
"""

import numpy as np
import pytest
import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops import trace as ttrace
from tinyraytracing_tpu_torch.ops.slot_test import SLOT
from tests.torch_port_util import SHADOW_RAYS, scan_rays, scene_pair, shadow_queries
from tests.torch_trace_emulate import emulate

SCENES = ("grid", "grid32", "cornell")


@pytest.fixture(scope="module", params=SCENES)
def scene(request):
    return request.param, *scene_pair(request.param)


def test_records_decode_to_the_packed_tree(scene):
    _, js, ts = scene
    rec = ts.trace_records
    assert ts.trace_records is rec                      # built once per scene
    assert rec.slot is ts.bvh_records.slot             # reused, not copied
    WN = np.asarray(js.bvh.packed.WN)
    PS = np.asarray(js.bvh.packed.PS)
    node = rec.node.numpy()
    n_wide = WN.shape[0]
    assert node.shape == (n_wide * 8, 8) and node.dtype == np.int32
    child = WN[:, :64].reshape(-1, 8)
    np.testing.assert_array_equal(node[:, :7], child[:, :7].view(np.int32))
    meta = child[:, 6].astype(np.int64)
    kids = (meta != -1).reshape(n_wide, 8).sum(1)
    # empty children trail every row
    np.testing.assert_array_equal(meta.reshape(n_wide, 8) != -1,
                                  np.arange(8) < kids[:, None])
    assert rec.root_kids == kids[0]
    slot_id = rec.slot_id.numpy()
    link = node[:, 7]
    leaf = meta <= -2
    dec = -meta[leaf] - 2
    first = link[leaf]
    # a leaf child's link: its first record, its count records in slot order
    for lid, cnt, f in zip(dec >> 6, dec & 63, first):
        np.testing.assert_array_equal(slot_id[f:f + cnt],
                                      lid * SLOT + np.arange(cnt))
    inner = meta >= 0
    np.testing.assert_array_equal(link[inner], kids[meta[inner]])
    assert (link[meta == -1] == 0).all()
    # every occupied slot has one record; shading records are PS rows 4-7
    assert slot_id.size == (dec & 63).sum()
    a = np.arange(16)
    col = (slot_id[:, None] >> 5) * 128 + (a % 4) * SLOT + (slot_id[:, None] & 31)
    np.testing.assert_array_equal(rec.shade.numpy().view(np.uint32),
                                  PS[4 + a // 4, col].view(np.uint32))
    np.testing.assert_array_equal(rec.slot.numpy().view(np.uint32),
                                  PS[a // 4, col].view(np.uint32))


def _rays(name, js, ts):
    """(8, 256) rays: 64 camera, 64 bounce and 64 shadow-direction rays of
    the scan renderer (unbounded, no target), and 64 bounded shadow queries
    toward light 0 with its material as target, every third parked."""
    org, d = scan_rays(ts, n_side=8, seed=3)
    rng = np.random.default_rng(4)
    so, sd, stb, stg = shadow_queries(js, rng, 64, *SHADOW_RAYS[name])
    stb[::3] = 0.0
    stg[::3] = -2.0
    n = org.shape[0]
    tb = np.concatenate([np.full(n, 3.0e38, np.float32), stb])
    tg = np.concatenate([np.full(n, -2.0, np.float32), stg])
    planes = np.concatenate([np.concatenate([org, so]).T,
                             np.concatenate([d, sd]).T, tb[None], tg[None]])
    return torch.from_numpy(np.ascontiguousarray(planes, np.float32))


QUERIES = (("closest", True, False), ("closest no-attrs", False, False),
           ("occlusion", False, True))


@pytest.mark.parametrize("order", ["preorder", "near"])
def test_emulated_kernel_walk_equals_plain(scene, order):
    name, js, ts = scene
    pk, rec = ts.bvh.packed, ts.trace_records
    rays = _rays(name, js, ts)
    cfg = RenderConfig(walk_order=order, bvh_walk="wide", ray_tile=128)
    kills = held = extra = 0
    for label, attrs, occl in QUERIES:
        tile, md = ttrace.walk_packets(pk, rays, cfg, occl)
        assert (md is not None) == (order == "near")
        stats = {}
        want = ttrace.trace_plain(pk, rays, cfg, attrs=attrs, occl=occl,
                                  tile=tile, md=md, stats=stats)
        for warp, hold in (((32, 2), (None, 4)) if order == "preorder"
                           else ((32, 2),)):
            reads = {}
            got = emulate(rec, rays, cfg, attrs=attrs, occl=occl, tile=tile,
                          md=md, warp=warp, hold=hold, reads=reads)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
                label, warp, hold, (got != want).sum(dim=1).tolist())
            held += reads["held"]
            extra += reads["slot_tests"] - stats["slot_tests"]
            assert reads["slot_tests"] >= stats["slot_tests"]
        kills += int((want[0] == -1.0).sum())
        if not occl:
            assert (want[6] >= 0).float().mean() > 0.3      # mostly hits
    assert kills > 0                                         # kills were seen
    # preorder: lanes held leaves (and on the grids tested leaves the plain
    # walk culls, which changed nothing)
    assert held > 0 if order == "preorder" else held == 0
    assert extra > 0 if order == "preorder" and name == "grid" else extra >= 0
