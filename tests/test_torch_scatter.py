"""The fixed-order scatter-adds (``ops/scatter.py``, ``csrc/scatter_add.cu``).

On the CPU: ``scatter_add_rows``' plain version is bitwise the CPU's
``index_add_`` (which adds in index order); the fixed-order plain version
follows its stated order bitwise, is within 1e-6 of its norm of a float64
sum and repeats bitwise; emulations of the two kernels' thread programs,
launch by launch and warp turn by warp turn as ``csrc/scatter_add.cu``
runs them (``tests/torch_scatter_emulate.py``: the count, the radix
passes' warp ranks and placement, the runs' adds, every level of the
fixed sums in one launch, its threads in two orders), equal the plain
versions bitwise, at the kernel's launch shape and at a small one that
takes several blocks, sub-tiles and passes, on the edge cases (rows past
keep and negative, one row taking every value, every row unique, fewer
than 32 values, a short last block, no values, 256 and 257 rows: one
sort pass and two); ``gather_rows``' gradient equals ``index_select``'s
within float rounding.

On the card (marked ``cuda``; they skip elsewhere; run them there with
``python -m pytest tests/test_torch_scatter.py -q --noconftest``): each
kernel bitwise its plain version, at the main paths' shapes
(``tests/torch_scatter_emulate.py``: the queue's image calls at 4 and
256 spp, ``render_regen``'s, cotangent tables of 1 to 100,000 rows) and
on the edge cases of the CPU tests; no wrapper call synchronizes
(``torch.cuda.set_sync_debug_mode("error")``); one call of each,
captured in a CUDA graph, replays bitwise; a call's graph holds at most
``scatter.DEVICE_OPS`` device ops; and renders and gradients that repeat
bitwise: two queue renders, two ``render_regen`` calls, two
``render_loss_fast`` and two scan ``render_loss`` gradients, and a
chunked, interrupted and resumed queue render against the one-shot one.
"""

import numpy as np
import pytest
import torch

from tinyraytracing_tpu_torch.ops import scatter
from tinyraytracing_tpu_torch.ops.lookup import gather_rows
# by its own name: the card's machine may have another package named tests
import torch_scatter_emulate as emu


def _values(rng, n, c):
    """float32 (n, c) spread over 12 decades, both signs."""
    mag = 10.0 ** rng.uniform(-6, 6, (n, 1))
    return (rng.standard_normal((n, c)) * mag).astype(np.float32)


def _repeated_rows(rng, n_rows, max_rep, n_drop, keep):
    """Every row of [0, n_rows) repeated 0..max_rep times (some exactly
    max_rep), plus ``n_drop`` rows at or past ``keep``, shuffled."""
    rep = rng.integers(0, max_rep + 1, n_rows)
    rep[rng.choice(n_rows, 4, replace=False)] = max_rep
    rows = np.repeat(np.arange(n_rows), rep)
    rows = np.concatenate([rows, rng.integers(keep, keep + 7, n_drop)])
    return torch.from_numpy(rng.permutation(rows))


@pytest.mark.parametrize("dim", [0, 1])
def test_rows_plain_equals_cpu_index_add(dim):
    rng = np.random.default_rng(10 + dim)
    n_pix, C = 300, 3
    rows = _repeated_rows(rng, n_pix, 8, 97, n_pix)
    n = rows.numel()
    src = torch.from_numpy(_values(rng, n, C))
    dst = torch.from_numpy(_values(rng, n_pix + 7, C))
    if dim == 1:
        src, dst = src.T.contiguous(), dst.T.contiguous()
    want = dst.clone().index_add_(dim, rows, src)
    got = scatter.scatter_add_rows_plain(dst.clone(), dim, rows, src,
                                         keep=n_pix)
    keep = (slice(0, n_pix),) if dim == 0 else (slice(None), slice(0, n_pix))
    assert torch.equal(got[keep], want[keep])
    assert torch.equal(got[keep].view(torch.int32), want[keep].view(torch.int32))
    # the rows past keep are left alone
    drop = (slice(n_pix, None),) if dim == 0 else (slice(None), slice(n_pix, None))
    assert torch.equal(got[drop], dst[drop])
    # the wrapper on the CPU is index_add_ itself
    assert torch.equal(scatter.scatter_add_rows(dst.clone(), dim, rows, src,
                                                keep=n_pix), want)


def _chain(vals, k):
    """The stated order: chunks of k from the row's first value, each
    summed left to right, level after level, in float32."""
    vals = list(vals)
    while True:
        nxt = []
        for i in range(0, len(vals), k):
            acc = vals[i]
            for v in vals[i + 1:i + k]:
                acc = np.float32(acc + v)
            nxt.append(acc)
        vals = nxt
        if len(vals) == 1:
            return vals[0]


@pytest.mark.parametrize("k", [4, scatter.FIXED_CHUNK])
def test_fixed_plain_follows_the_stated_order(k):
    """Run lengths around the chunk and level boundaries, one channel."""
    rng = np.random.default_rng(3)
    lengths = [1, 2, k - 1, k, k + 1, k * k, k * k + 1, 3 * k * k + 5]
    rows = torch.from_numpy(rng.permutation(
        np.repeat(np.arange(len(lengths)), lengths)))
    src = torch.from_numpy(_values(rng, rows.numel(), 1))
    got = scatter.scatter_add_rows_fixed_plain(len(lengths) + 2, rows, src, k)
    for r in range(len(lengths)):
        vals = src[:, 0][rows == r].numpy()         # ascending position
        assert got[r, 0].item() == float(_chain(vals, k)), r
    assert not got[len(lengths):].any()


def test_fixed_plain_against_float64_and_repeats():
    rng = np.random.default_rng(4)
    for n, n_rows in ((70_000, 4), (50_000, 20_000), (4096, 300)):
        rows = torch.from_numpy(rng.integers(0, n_rows, n))
        src = torch.from_numpy(_values(rng, n, 3))
        got = scatter.scatter_add_rows_fixed_plain(n_rows, rows, src)
        ref = torch.zeros(n_rows, 3, dtype=torch.float64).index_add_(
            0, rows, src.double())
        assert float((got.double() - ref).norm()) <= 1e-6 * float(ref.norm())
        again = scatter.scatter_add_rows_fixed_plain(n_rows, rows, src)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        assert torch.equal(scatter.scatter_add_rows_fixed(n_rows, rows, src), got)


def test_fixed_plain_places_rows_that_appear_once():
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.permutation(1000)[:600])
    src = torch.from_numpy(_values(rng, 600, 3)).reshape(600, 3, 1)
    want = torch.zeros(1000, 3, 1)
    want[rows] = src
    got = scatter.scatter_add_rows_fixed_plain(1000, rows, src)
    assert got.shape == (1000, 3, 1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # short runs (at most one chunk) are index_add_'s chain into zero
    rows = torch.from_numpy(rng.integers(0, 300, 2000))
    src = torch.from_numpy(_values(rng, 2000, 2))
    assert torch.equal(scatter.scatter_add_rows_fixed_plain(300, rows, src),
                       torch.zeros(300, 2).index_add_(0, rows, src))


def _emulate_rows_kernel(dst, dim, rows, src, keep, shape=emu.KERNEL, order=None):
    """csrc/scatter_add.cu's trt_scatter_rows, phase by phase and warp
    turn by warp turn (tests/torch_scatter_emulate.py), its claims in
    ``order``."""
    d = dst.numpy().copy()
    emu.rows_add(d, dim, rows.numpy(), src.numpy(), keep, shape, order)
    return torch.from_numpy(d)


def _emulate_fixed_kernel(n_rows, rows, src, k, shape=emu.KERNEL, order=None):
    """csrc/scatter_add.cu's trt_scatter_fixed: the sort, then the sums of
    every level in one launch, its threads one after another in ``order``."""
    out = emu.fixed_sum(n_rows, rows.numpy(), src.numpy(), k, shape, order)
    return torch.from_numpy(out.reshape(n_rows, *src.shape[1:]))


@pytest.mark.parametrize("dim", [0, 1])
def test_rows_kernel_emulation_equals_index_add(dim):
    rng = np.random.default_rng(20 + dim)
    rows = _repeated_rows(rng, 60, 8, 30, 60)
    src = torch.from_numpy(_values(rng, rows.numel(), 3))
    dst = torch.from_numpy(_values(rng, 67, 3))
    if dim == 1:
        src, dst = src.T.contiguous(), dst.T.contiguous()
    got = _emulate_rows_kernel(dst.clone(), dim, rows, src, 60)
    want = scatter.scatter_add_rows_plain(dst.clone(), dim, rows, src, keep=60)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("k,n,n_rows", [(4, 700, 3), (4, 300, 120),
                                        (scatter.FIXED_CHUNK, 1500, 2),
                                        (scatter.FIXED_CHUNK, 40, 40)])
def test_fixed_kernel_emulation_equals_plain(k, n, n_rows):
    rng = np.random.default_rng(n)
    rows = torch.from_numpy(rng.integers(0, n_rows, n))
    src = torch.from_numpy(_values(rng, n, 2))
    got = _emulate_fixed_kernel(n_rows + 1, rows, src, k)
    want = scatter.scatter_add_rows_fixed_plain(n_rows + 1, rows, src, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# a launch shape of 128-item sub-tiles, at most 3 blocks and 3-bit digits:
# several blocks, sub-tiles a block and sort passes at a few thousand rows
SMALL = emu.Shape(threads=64, items=2, max_blocks=3, digit_bits=3)
SHAPES = {"kernel": emu.KERNEL, "small": SMALL}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", emu.ROWS_CASES)
def test_rows_kernel_emulation_edge_cases(case, shape):
    rows, dst, src, dim, keep = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in emu.rows_case(case))
    want = scatter.scatter_add_rows_plain(dst.clone(), dim, rows, src, keep=keep)
    shuffled = np.random.default_rng(8).permutation(rows.numel())
    for order in (None, shuffled):                 # the claims' order
        got = _emulate_rows_kernel(dst.clone(), dim, rows, src, keep,
                                   SHAPES[shape], order)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    past = (slice(keep, None),) if dim == 0 else (slice(None), slice(keep, None))
    assert torch.equal(got[past], dst[past])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", emu.FIXED_CASES)
def test_fixed_kernel_emulation_edge_cases(case, shape):
    """Bitwise the plain version, whichever lane finishes a node last:
    the sums' lanes in ascending order and in a shuffled one."""
    rows, src, n_rows = emu.fixed_case(case)
    rows, src = torch.from_numpy(rows), torch.from_numpy(src)
    want = scatter.scatter_add_rows_fixed_plain(n_rows, rows, src)
    shuffled = np.random.default_rng(7).permutation(rows.numel())
    for order in (None, shuffled):
        got = _emulate_fixed_kernel(n_rows, rows, src, scatter.FIXED_CHUNK,
                                    SHAPES[shape], order)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_emulation_constants_are_the_kernels():
    """The emulation's launch constants and plan are the source's."""
    from pathlib import Path

    text = (Path(scatter.__file__).parents[1] / "csrc" / "scatter_add.cu").read_text()
    for name, value in (("THREADS", emu.KERNEL.threads), ("ITEMS", emu.KERNEL.items),
                        ("MAX_BLOCKS", emu.KERNEL.max_blocks),
                        ("DIGIT_BITS", emu.KERNEL.digit_bits), ("SLOTS", emu.SLOTS)):
        assert f"constexpr int {name} = {value};" in text, name
    # passes per row count: one up to 256 rows, three at 2^20
    assert [len(emu.make_plan(1000, k).passes) for k in (0, 1, 2, 256, 257, 1 << 20)] \
        == [1, 1, 1, 1, 2, 3]
    for n in (1, 4096, 4097, 262_144, 262_145, 1 << 21):
        p = emu.make_plan(n, 7)
        assert p.G <= emu.KERNEL.max_blocks and p.G * p.BS >= n
        assert (p.G - 1) * p.BS < n and p.BS % emu.KERNEL.tile == 0


@pytest.mark.parametrize("shape", [(9,), (9, 3), (9, 3, 3)])
def test_gather_rows_grad_matches_index_select(shape):
    rng = np.random.default_rng(6)
    table = torch.from_numpy(_values(rng, 9, int(np.prod(shape[1:])))).reshape(shape)
    rows = torch.from_numpy(rng.integers(0, 9, (50, 40)))
    g = torch.from_numpy(rng.standard_normal((50, 40, *shape[1:])).astype(np.float32))
    a = table.clone().requires_grad_(True)
    out = gather_rows(a, rows)
    assert torch.equal(out, table[rows])
    out.backward(g)
    b = table.clone().requires_grad_(True)
    torch.index_select(b, 0, rows.reshape(-1)).reshape(out.shape).backward(g)
    assert torch.allclose(a.grad, b.grad, rtol=1e-5, atol=1e-6)
    assert torch.equal(a.grad, scatter.scatter_add_rows_fixed_plain(
        9, rows.reshape(-1), g.reshape(-1, *shape[1:])))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    return t.detach().contiguous().view(torch.int32).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [0, 1])
def test_rows_kernel_bitwise_equal_plain(dim, device):
    rng = np.random.default_rng(30 + dim)
    n_pix = 1 << 16
    rows = _repeated_rows(rng, n_pix, 4, 70_000, n_pix).to(device)
    src = torch.from_numpy(_values(rng, rows.numel(), 3)).to(device)
    dst = torch.from_numpy(_values(rng, n_pix + 7, 3)).to(device)
    if dim == 1:
        src, dst = src.T.contiguous(), dst.T.contiguous()
    scatter.reset_launch_counts()
    got = scatter.scatter_add_rows(dst.clone(), dim, rows, src, keep=n_pix)
    assert scatter.LAUNCHES["scatter_rows"] == 1
    want = scatter.scatter_add_rows_plain(dst.clone(), dim, rows, src, keep=n_pix)
    keep = (slice(0, n_pix),) if dim == 0 else (slice(None), slice(0, n_pix))
    assert torch.equal(_bits(got[keep]), _bits(want[keep]))
    cpu = dst.cpu().index_add_(dim, rows.cpu(), src.cpu())
    assert torch.equal(_bits(got[keep]), _bits(cpu[keep]))


def _rows_call(case, device):
    """(rows, dst, src, dim, keep) on the card: a main path's call at full
    width ("queue", "queue 256 spp", "regen") or an edge case of the CPU
    tests."""
    make = {"queue": emu.queue_call, "regen": emu.regen_call,
            "queue 256 spp": lambda: emu.queue_call(spp=256)}.get(case)
    args = make() if make else emu.rows_case(case)
    return tuple(torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
                 else a for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("queue", "queue 256 spp", "regen",
                                  *emu.ROWS_CASES))
def test_rows_kernel_bitwise_equal_plain_main_paths_and_edges(case, device):
    rows, dst, src, dim, keep = _rows_call(case, device)
    scatter.reset_launch_counts()
    got = scatter.scatter_add_rows(dst.clone(), dim, rows, src, keep=keep)
    assert scatter.LAUNCHES["scatter_rows"] == (1 if rows.numel() else 0)
    want = scatter.scatter_add_rows_plain(dst.clone(), dim, rows, src, keep=keep)
    assert torch.equal(_bits(got), _bits(want))
    # int32 row ids give the same bits
    got32 = scatter.scatter_add_rows(dst.clone(), dim, rows.int(), src, keep=keep)
    assert torch.equal(_bits(got32), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_rows,c", [(262_144, 4, 3), (262_144, 100_000, 3),
                                        (33, 5, 18), (1, 1, 1),
                                        (262_144, 1, 3), (262_144, 2, 3),
                                        (262_144, 32, 3), (262_144, 256, 3),
                                        (262_144, 257, 3), (524_288, 3, 3)])
def test_fixed_kernel_bitwise_equal_plain(n, n_rows, c, device):
    rng = np.random.default_rng(n + n_rows)
    rows = torch.from_numpy(rng.integers(0, n_rows, n)).to(device)
    src = torch.from_numpy(_values(rng, n, c)).to(device)
    scatter.reset_launch_counts()
    got = scatter.scatter_add_rows_fixed(n_rows, rows, src)
    again = scatter.scatter_add_rows_fixed(n_rows, rows, src)
    assert scatter.LAUNCHES["scatter_fixed"] == 2
    want = scatter.scatter_add_rows_fixed_plain(n_rows, rows, src)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(_bits(got), _bits(scatter.scatter_add_rows_fixed_plain(
        n_rows, rows.cpu(), src.cpu())))


@pytest.mark.cuda
@pytest.mark.parametrize("case", emu.FIXED_CASES)
def test_fixed_kernel_edge_cases_bitwise_equal_plain(case, device):
    rows, src, n_rows = emu.fixed_case(case)
    rows, src = torch.from_numpy(rows).to(device), torch.from_numpy(src).to(device)
    got = scatter.scatter_add_rows_fixed(n_rows, rows, src)
    want = scatter.scatter_add_rows_fixed_plain(n_rows, rows, src)
    assert torch.equal(_bits(got), _bits(want))


def _fixed_call(n_rows, device, n=262_144):
    rng = np.random.default_rng(n_rows)
    return (torch.from_numpy(rng.integers(0, n_rows, n)).to(device),
            torch.from_numpy(_values(rng, n, 3)).to(device))


@pytest.mark.cuda
def test_wrappers_never_synchronize(device):
    """No wrapper call reads anything back to the host."""
    calls = [lambda a=_rows_call(case, device): scatter.scatter_add_rows(
                 a[1].clone(), a[3], a[0], a[2], keep=a[4])
             for case in ("queue", "queue 256 spp", "regen")]
    calls += [lambda a=_fixed_call(m, device), m=m: scatter.scatter_add_rows_fixed(m, *a)
              for m in (2, 32, 100_000)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("queue", "queue 256 spp", "regen"))
def test_rows_call_replays_bitwise_in_a_cuda_graph(case, device):
    rows, dst0, src, dim, keep = _rows_call(case, device)
    want = scatter.scatter_add_rows(dst0.clone(), dim, rows, src, keep=keep)
    static = dst0.clone()
    graph, _ = emu.captured(lambda: scatter.scatter_add_rows(static, dim, rows,
                                                             src, keep=keep))
    for _ in range(2):
        static.copy_(dst0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(static), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [2, 32, 100_000])
def test_fixed_call_replays_bitwise_in_a_cuda_graph(n_rows, device):
    rows, src = _fixed_call(n_rows, device)
    want = scatter.scatter_add_rows_fixed(n_rows, rows, src)
    graph, out = emu.captured(lambda: scatter.scatter_add_rows_fixed(n_rows, rows, src))
    for _ in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(want))


@pytest.mark.cuda
def test_device_ops_per_call(device):
    """At most ``scatter.DEVICE_OPS`` a call (the images one cooperative
    launch, the cotangents two launches), counted as the nodes of the
    call's CUDA graph, at the main paths' shapes and cotangent tables of 2
    to 100,000 rows."""
    for case in ("queue", "queue 256 spp", "regen"):
        rows, dst, src, dim, keep = _rows_call(case, device)
        ops = emu.device_ops(lambda: scatter.scatter_add_rows(dst, dim, rows, src,
                                                              keep=keep))
        assert 0 < ops <= scatter.DEVICE_OPS["scatter_rows"] == 1, (case, ops)
    for n_rows in (2, 32, 256, 100_000):
        rows, src = _fixed_call(n_rows, device)
        ops = emu.device_ops(lambda: scatter.scatter_add_rows_fixed(n_rows, rows, src))
        assert 0 < ops <= scatter.DEVICE_OPS["scatter_fixed"] == 2, (n_rows, ops)


@pytest.mark.cuda
def test_queue_renders_repeat_bitwise(device):
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue
    from tinyraytracing_tpu_torch.models.procedural import quad_grid
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    scene, cam = quad_grid(6000, 64, 64, device=device)
    cfg, key = RenderConfig(), master_key_data(0)
    scatter.reset_launch_counts()
    a, ra = render_fused_queue(scene, cam, key, cfg, 4, lanes=4096)
    assert scatter.LAUNCHES["scatter_rows"] > 0
    b, rb = render_fused_queue(scene, cam, key, cfg, 4, lanes=4096)
    assert torch.equal(_bits(a), _bits(b)) and float(ra) == float(rb)


@pytest.mark.cuda
def test_regen_renders_repeat_bitwise(device):
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.integrator.regen import render_regen
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    cfg = RenderConfig(intersector="bvh_pallas")
    scene, cam = cornell_box(48, 48, device=device)
    scene = attach_bvh(scene, cfg)
    key = master_key_data(3)
    scatter.reset_launch_counts()
    a, _ = render_regen(scene, cam, key, cfg, 4, lanes=2048)
    assert scatter.LAUNCHES["scatter_rows"] > 0
    b, _ = render_regen(scene, cam, key, cfg, 4, lanes=2048)
    assert torch.equal(_bits(a), _bits(b))


def _grads_twice(loss_fn, scene, cam, cfg, fields, device):
    from tinyraytracing_tpu_torch.diff import SceneParams
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    out = []
    for _ in range(2):
        p = SceneParams.init_from(scene, cam, *fields)
        for t in p.tensors():
            t.requires_grad_(True)
        loss = loss_fn(p, scene, cam, master_key_data(1),
                       torch.zeros(cam.height, cam.width, 3, device=device),
                       cfg, 2)
        loss.backward()
        out.append((loss.detach(), [t.grad for t in p.tensors()]))
    (la, ga), (lb, gb) = out
    assert torch.equal(_bits(la), _bits(lb))
    for a, b in zip(ga, gb):
        assert float(a.abs().sum()) > 0
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_fast_loss_gradients_repeat_bitwise(device):
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.diff import render_loss_fast
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

    cfg = RenderConfig(max_depth=3)
    scene, cam = cornell_box(64, 64, device=device)
    scene = attach_bvh(scene, cfg)
    scatter.reset_launch_counts()
    _grads_twice(render_loss_fast, scene, cam, cfg,
                 ("kd", "vertex_offset", "eye"), device)
    assert scatter.LAUNCHES["scatter_fixed"] > 0


@pytest.mark.cuda
def test_scan_loss_gradients_repeat_bitwise(device):
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.diff import render_loss
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

    cfg = RenderConfig(intersector="bvh_pallas", max_depth=3)
    scene, cam = cornell_box(64, 64, device=device)
    scene = attach_bvh(scene, cfg)
    _grads_twice(render_loss, scene, cam, cfg, ("kd", "radiance"), device)


@pytest.mark.cuda
def test_resumed_queue_render_is_the_one_shot_render(device, tmp_path):
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.integrator.fused_queue import (
        render_fused_queue, render_fused_queue_chunked,
    )
    from tinyraytracing_tpu_torch.models.procedural import quad_grid
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    class Interrupted(Exception):
        pass

    scene, cam = quad_grid(6000, 64, 64, device=device)
    cfg, key = RenderConfig(), master_key_data(0)
    one, rays = render_fused_queue(scene, cam, key, cfg, 4, lanes=4096)
    kw = dict(lanes=4096, target_chunk_s=1e-9,
              checkpoint_path=str(tmp_path / "q.npz"), checkpoint_every_s=0.0)
    seen = []

    def stop(it, counter, seconds):
        seen.append(it)
        if len(seen) == 3:
            raise Interrupted

    with pytest.raises(Interrupted):
        render_fused_queue_chunked(scene, cam, key, cfg, 4, progress=stop, **kw)
    got, rays2 = render_fused_queue_chunked(scene, cam, key, cfg, 4,
                                            resume=True, **kw)
    assert torch.equal(_bits(got), _bits(one)) and float(rays2) == float(rays)
