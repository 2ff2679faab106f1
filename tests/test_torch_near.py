"""The near-first walk (``walk_order="near"``, the ordered branch of the
JAX kernel's ``_interior_push`` with its pop-time cull) of the port's trace
against the JAX package's Pallas kernel in interpret mode, on the same
scene, rays and config.

The config is ``walk_order="near"``, ``bvh_walk="wide"`` and
``ray_tile=128``, so every call walks several packets, each with its own
key. The rays (tests/torch_aligned_near.py): random rays, the scan
renderer's camera, bounce and shadow rays, and shadow queries with and
without parked lanes; the JAX side runs in a process of its own with
XLA's FMA contraction off, which otherwise flips a few self-hits of the
rays that start on a surface. Discrete outputs (hit, material, emissive
flag, triangle, kill, visibility) must be equal and floats within
check_closest's tolerances, lane for lane. The one admitted exception is
a lane whose result the walk order may decide: two hits within the tie
band of each other (|t_a - t_b| <= tie_eps * t), met in another order
because two children's keys tie. Such lanes are counted and shown, never
folded into a looser tolerance for all lanes; on these rays there were
none.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracing_tpu.ops.pallas_trace import _mean_dir
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops import trace as ttrace
from tests.test_torch_trace import check_closest
from tests.torch_aligned_near import NEAR
from tests.torch_port_util import planes, scan_rays, scene_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("cornell", "grid", "grid32")
TIE_EPS = RenderConfig().tie_eps


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """Every case's rays and JAX results, one process per scene side by
    side, each with FMA contraction off (tests/torch_aligned_near.py)."""
    tmp = tmp_path_factory.mktemp("near")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX"))
    outs = {n: str(tmp / f"{n}.npz") for n in SCENES}
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_aligned_near",
                               out, n], cwd=ROOT, env=env)
             for n, out in outs.items()]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert rcs == [0] * len(SCENES), rcs
    res = {}
    for n, out in outs.items():
        with np.load(out) as f:
            res[n] = dict(f)
    return res


def tie_band_lanes(j, t, planes_):
    """Lanes whose ``planes_`` differ between the two outputs; each must
    be a tie-band case of the distance plane 0. Returns their mask."""
    diff = np.zeros(j[0].shape, bool)
    for k in planes_:
        diff |= t[k] != j[k]
    ta, tj = t[0][diff], j[0][diff]
    band = np.abs(ta - tj) <= TIE_EPS * np.maximum(np.abs(ta), np.abs(tj))
    assert band.all(), (f"{int((~band).sum())} lanes differ outside the tie "
                        f"band: port t {ta[~band]}, JAX t {tj[~band]}")
    if diff.any():
        print(f"{int(diff.sum())} tie-band lanes: port t {ta}, JAX t {tj}")
    return diff


def check_near(j, t, attrs=True):
    """check_closest on every lane outside the tie-band exceptions."""
    diff = tie_band_lanes(j, t, [6, 7] + ([8] if len(j) == 9 else []))
    check_closest([x[~diff] for x in j], [x[~diff] for x in t], attrs=attrs)
    return diff


@pytest.mark.parametrize("query", ["closest", "closest_bounded", "occlusion"])
@pytest.mark.parametrize("name", SCENES)
def test_near_matches_pallas_kernel(name, query, jax_out):
    _, ts = scene_pair(name)
    out = jax_out[name]
    org, d, tb, tg = (out[f"{query}-{k}"] for k in ("org", "dir", "tb", "tg"))
    n_planes = {"closest": 9, "closest_bounded": 8, "occlusion": 2}[query]
    j = [out[f"{query}-{k}"] for k in range(n_planes)]
    kw = dict(t_bound=torch.from_numpy(tb), target_mtl=torch.from_numpy(tg))
    if query == "closest":
        kw["return_tri"] = True
    elif query == "closest_bounded":
        kw["attrs"] = False
    else:
        kw["query"] = "occlusion"
    t = [x.numpy() for x in ttrace.fused_trace_planes(
        ts, *map(torch.from_numpy, planes(org)),
        *map(torch.from_numpy, planes(d)), RenderConfig(**NEAR), **kw)]
    if query == "closest":
        diff = check_near(j, t)
        hit = t[6] >= 0
        assert 0.3 < hit.mean() < 1.0
        assert (t[8][hit & ~diff] >= 0).all()
    elif query == "closest_bounded":
        check_near(j, t, attrs=False)
        assert (t[6] == -3.0).any() and (t[6] == tg).any()
        assert (t[6][tb == 0.0] == -1.0).all()            # parked: a miss
    else:
        diff = tie_band_lanes(j, t, [0, 1])
        np.testing.assert_array_equal(t[1][~diff], j[1][~diff])     # seen
        np.testing.assert_array_equal(t[0][~diff], j[0][~diff])     # bt
        vis = (t[1] > 0.5) & (t[0] >= 0.0)
        assert vis.any() and not vis.all()


def test_near_dispatch_follows_the_jax_walk():
    """Near applies only where the JAX kernel walks the wide tree: the
    binary walk (small trees' closest hits under "auto", or "binary")
    ignores the order; the packet size is the JAX kernel's."""
    near = RenderConfig(walk_order="near")
    cornell = scene_pair("cornell")[1].bvh.packed         # 11 binary nodes
    grid = scene_pair("grid")[1].bvh.packed               # 1,981 nodes
    assert ttrace.near_tile(cornell, near, occl=False) == 0
    assert ttrace.near_tile(cornell, near, occl=True) == ttrace.RAY_TILE
    assert ttrace.near_tile(grid, near, occl=False) == ttrace.RAY_TILE
    assert ttrace.near_tile(grid, near.replace(bvh_walk="binary"), True) == 0
    assert ttrace.near_tile(grid, near.replace(ray_tile=256), False) == 256
    assert ttrace.near_tile(grid, RenderConfig(bvh_walk="wide"), True) == 0
    big = type("Packed", (), dict(n_wide=1883, n_nodes=20000, leaf_size=8))
    assert ttrace.near_tile(big, near, False) == 2048
    big.leaf_size = 32
    assert ttrace.near_tile(big, near, False) == ttrace.RAY_TILE_BIG


def test_packet_sums_equal_mean_dir():
    """The port's packet direction sums equal ``_mean_dir`` on the JAX
    kernel's packets (zero-padded last packet), bit for bit, at the JAX
    kernel's packet sizes."""
    rng = np.random.default_rng(44)
    for tile in (128, 256, 1024, 2048, 4096):
        R = 2 * tile + 300
        d = rng.normal(size=(R, 3))        # incoherent, and camera-like:
        if tile % 256 == 0:
            d += (0.2, 0.1, 2.0)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        rays = torch.zeros(8, R)
        rays[3:6] = torch.from_numpy(np.ascontiguousarray(d.T))
        got = ttrace.packet_dirs(rays, tile).numpy()
        pad = np.zeros((got.shape[0] * tile, 3), np.float32)
        pad[:R] = d
        mean_dir = jax.jit(_mean_dir)
        want = np.array(
            [[float(x) for x in mean_dir(*(
                jnp.asarray(pad[p * tile:(p + 1) * tile, k].reshape(-1, 128))
                for k in range(3)))] for p in range(got.shape[0])],
            np.float32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", [8192, 16384])
def test_packet_sums_equal_jnp_sum_tall_packets(tile):
    """Packets taller than 32 rows (``ray_tile`` 8192 and up): XLA adds
    each 32-row band's four window sums in order and the band sums
    pairwise, and ``packet_dirs_plain`` adds in that order, bitwise
    ``jnp.sum`` of the JAX packet block, with a ragged last packet."""
    rng = np.random.default_rng(tile)
    R = 2 * tile + 1000
    d = rng.normal(size=(R, 3)) + (0.2, 0.1, 2.0)     # camera-like
    d[:R // 2] = rng.normal(size=(R // 2, 3))           # and incoherent
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = torch.zeros(8, R)
    rays[3:6] = torch.from_numpy(np.ascontiguousarray(d.T))
    got = ttrace.packet_dirs_plain(rays, tile).numpy()
    pad = np.zeros((got.shape[0] * tile, 3), np.float32)
    pad[:R] = d
    mean_dir = jax.jit(_mean_dir)
    want = np.array(
        [[float(x) for x in mean_dir(*(
            jnp.asarray(pad[p * tile:(p + 1) * tile, k].reshape(-1, 128))
            for k in range(3)))] for p in range(got.shape[0])], np.float32)
    assert got.shape == (3, 3)
    np.testing.assert_array_equal(got, want)


def test_near_walk_orders_and_culls():
    """On the same rays the near walk returns the preorder walk's planes
    (no ties here) and tests fewer slots: front-to-back order shrinks
    the bound sooner, and the pop-time cull skips what it left behind."""
    _, ts = scene_pair("grid")
    pk = ts.bvh.packed
    org, d = scan_rays(ts, n_side=16, seed=1)
    rays = torch.cat([torch.from_numpy(np.ascontiguousarray(org.T)),
                      torch.from_numpy(np.ascontiguousarray(d.T)),
                      torch.full((1, len(org)), 3.0e38),
                      torch.full((1, len(org)), -2.0)]).contiguous()
    near = RenderConfig(**NEAR)
    tile, md = ttrace.walk_packets(pk, rays, near, occl=False)
    assert tile == 128 and md.shape == (len(org) // 128, 3)
    pre_stats, near_stats = {}, {}
    pre = ttrace.trace_plain(pk, rays, near, stats=pre_stats)
    got = ttrace.trace_plain(pk, rays, near, tile=tile, md=md,
                             stats=near_stats)
    assert torch.equal(got, pre)
    assert near_stats["slot_tests"] < pre_stats["slot_tests"]
    assert near_stats["node_visits"] < pre_stats["node_visits"]
