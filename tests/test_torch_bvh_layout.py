"""The packet-BVH kernel's layout (``ops.bvh_intersect.bvh_records``,
``Scene.bvh_records``) against the JAX package's packed tree it is built
from: every node record decodes to the JAX node_box's box bitwise and to
its node_meta exactly, every occupied slot's record holds its 16 P
attributes bitwise, pad slots get no record, and each leaf's first record
and count cover exactly its slot ids 32*leaf + s. Scenes: cornell at leaf
8, quad_grid(6000) at leaf 8 and 32, and cornell at leaf 1.
"""

import numpy as np
import pytest
import torch

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.models import procedural as jproc
from tinyraytracing_tpu.ops.bvh import attach_bvh
from tests.torch_port_util import port_scene, scene_pair

SCENES = ("cornell", "grid", "grid32", "cornell_leaf1")


def _pair(name):
    if name == "cornell_leaf1":
        js, _ = jproc.cornell_box(32, 32)
        js = attach_bvh(js, JConfig(leaf_size=1))
        return js, port_scene(js)
    return scene_pair(name)


@pytest.fixture(scope="module", params=SCENES)
def layout(request):
    """(JAX packed arrays as numpy, the port scene's records as numpy)."""
    js, ts = _pair(request.param)
    jp = js.bvh.packed
    jax_np = {k: np.asarray(getattr(jp, k)) for k in ("node_box", "node_meta",
                                                      "P", "tid")}
    jax_np["leaf_size"] = int(jp.leaf_size)
    rec = ts.bvh_records
    assert ts.bvh_records is rec                       # built once per scene
    return jax_np, {"node": rec.node.numpy(), "slot": rec.slot.numpy(),
                    "tid": rec.tid.numpy(), "n_nodes": rec.n_nodes}


def _leaves(meta):
    """(leaf nodes, their leaf ids, their counts) from node_meta."""
    node = np.nonzero(meta[:, 1] >= 0)[0]
    return node, meta[node, 1] >> 6, meta[node, 1] & 63


def test_node_records_decode_to_the_packed_tree(layout):
    jx, rec = layout
    node = rec["node"]
    N = jx["node_box"].shape[0]
    assert node.shape == (N, 8) and node.dtype == np.int32 and rec["n_nodes"] == N
    np.testing.assert_array_equal(node[:, :6].view(np.float32).view(np.uint32),
                                  jx["node_box"][:, :6].view(np.uint32))
    enc = node[:, 7]
    leaf = enc >= 0
    skip = np.where(leaf, np.arange(N) + 1, node[:, 6])   # a leaf's skip: next
    np.testing.assert_array_equal(np.stack([skip, enc], 1), jx["node_meta"])


def test_slot_records_hold_the_occupied_slots(layout):
    jx, rec = layout
    P, slot = jx["P"], rec["slot"]
    node, leaf, count = _leaves(jx["node_meta"])
    first = rec["node"][node, 6]
    assert slot.shape == (int(count.sum()), 16) and slot.dtype == np.float32
    assert 0 < count.max() <= jx["leaf_size"]
    seen = np.zeros(slot.shape[0], bool)
    a = np.arange(16)
    for f, l, c in zip(first, leaf, count):
        for s in range(c):
            want = P[a // 4, l * 128 + (a % 4) * 32 + s]
            np.testing.assert_array_equal(slot[f + s].view(np.uint32),
                                          want.view(np.uint32))
            assert not seen[f + s]
            seen[f + s] = True
    assert seen.all()                 # every record is some occupied slot


def test_no_records_for_pad_slots(layout):
    """Pad slots (beyond a leaf's count) are all-zero P rows and map to
    triangle 0; none of them has a record, and every occupied slot maps to
    a triangle."""
    jx, rec = layout
    P = jx["P"]
    node, leaf, count = _leaves(jx["node_meta"])
    n_blk = P.shape[1] // 128
    blocks = P.reshape(4, n_blk, 4, 32).transpose(1, 3, 0, 2).reshape(n_blk, 32, 16)
    occupied = np.zeros((n_blk, 32), bool)
    occupied[leaf[:, None], np.arange(32)[None]] = np.arange(32)[None] < count[:, None]
    assert (blocks[~occupied] == 0).all()
    assert rec["slot"].shape[0] == occupied.sum()
    assert (jx["tid"].reshape(n_blk, 32)[~occupied] == 0).all()
    np.testing.assert_array_equal(rec["tid"], jx["tid"])


def test_leaf_records_cover_their_slot_ids(layout):
    """The records [first, first + count) of each leaf are its slot ids
    32*leaf + 0 .. count-1, so the kernel's carried slot id maps to the
    triangle through tid as the JAX kernel's does; together the leaves
    cover every record once, in leaf-id order."""
    jx, rec = layout
    node, leaf, count = _leaves(jx["node_meta"])
    first = rec["node"][node, 6]
    ids = np.full(rec["slot"].shape[0], -1, np.int64)
    for f, l, c in zip(first, leaf, count):
        assert (ids[f:f + c] == -1).all()
        ids[f:f + c] = 32 * l + np.arange(c)
    order = np.argsort(leaf)
    np.testing.assert_array_equal(first[order],
                                  np.cumsum(count[order]) - count[order])
    assert (ids >= 0).all() and (np.diff(ids) > 0).all()
    tri = jx["tid"][ids]
    assert len(np.unique(tri)) == len(tri)           # one record per triangle


def test_layout_moves_with_the_scene():
    """Built on the scene's device, from the scene's own tree: a scene
    moved to another device (a new object) builds its own."""
    _, ts = scene_pair("cornell")
    moved = ts.to("cpu")
    assert moved.bvh_records is not ts.bvh_records
    assert torch.equal(moved.bvh_records.node, ts.bvh_records.node)
    assert moved.bvh_records.node.device == moved.device
