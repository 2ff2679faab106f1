"""The fixed-order scatter-adds (``ops/scatter.py``, ``csrc/scatter_add.cu``).

On the CPU: ``scatter_add_rows``' plain version is bitwise the CPU's
``index_add_`` (which adds in index order); the fixed-order plain version
follows its stated order bitwise, is within 1e-6 of its norm of a float64
sum and repeats bitwise; emulations of the two kernels' thread programs,
step by step as ``csrc/scatter_add.cu`` runs them, equal the plain
versions bitwise; ``gather_rows``' gradient equals ``index_select``'s
within float rounding.

On the card (marked ``cuda``; they skip elsewhere; run them there with
``python -m pytest tests/test_torch_scatter.py -q --noconftest``): each
kernel bitwise its plain version, and renders and gradients that repeat
bitwise: two queue renders, two ``render_regen`` calls, two
``render_loss_fast`` and two scan ``render_loss`` gradients, and a
chunked, interrupted and resumed queue render against the one-shot one.
"""

import numpy as np
import pytest
import torch

from tinyraytracing_tpu_torch.ops import scatter
from tinyraytracing_tpu_torch.ops.lookup import gather_rows


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


def _emulate_rows_kernel(dst, dim, rows, src, keep):
    """csrc/scatter_add.cu's scatter_rows_kernel, thread by thread."""
    srow, perm = (t.numpy() for t in scatter._sorted_rows(rows))
    d, s = dst.numpy(), src.numpy()
    n = srow.size
    for i in range(n):
        r = srow[i]
        if r < 0 or r >= keep or (i > 0 and srow[i - 1] == r):
            continue
        e = i + 1
        while e < n and srow[e] == r:
            e += 1
        for c in range(d.shape[1 - dim]):
            at = (r, c) if dim == 0 else (c, r)
            acc = d[at]
            for j in range(i, e):
                acc = np.float32(acc + s[(perm[j], c) if dim == 0 else (c, perm[j])])
            d[at] = acc
    return dst


def _emulate_fixed_kernel(n_rows, rows, src, k):
    """csrc/scatter_add.cu's trt_scatter_fixed: its levels, and each
    level's threads one after another (a level's threads read one buffer
    and write the other, so their order does not matter)."""
    srow, perm = (t.numpy() for t in scatter._sorted_rows(rows))
    n = srow.size
    x = src.reshape(n, -1).numpy()
    C = x.shape[1]
    dst = np.zeros((n_rows, C), np.float32)
    bufs = (np.full((n, C), np.nan, np.float32), np.full((n, C), np.nan, np.float32))
    run_s, run_e = np.zeros(n, np.int64), np.zeros(n, np.int64)
    kpow, level = 1, 0
    while True:
        out, inp = bufs[level & 1], bufs[(level & 1) ^ 1]
        for p in range(n):
            if level == 0:
                run_s[p] = np.searchsorted(srow, srow[p], "left")
                run_e[p] = np.searchsorted(srow, srow[p], "right")
            s, e = run_s[p], run_e[p]
            m_in = (e - s + kpow - 1) // kpow
            if level > 0 and m_in == 1:
                continue
            m_out = (m_in + k - 1) // k
            q = p - s
            if q >= m_out:
                continue
            first = q * k
            ln = min(m_in - first, k)
            for c in range(C):
                read = ((lambda t: x[perm[s + first + t], c]) if level == 0
                        else (lambda t: inp[s + first + t, c]))
                acc = read(0)
                for t in range(1, ln):
                    acc = np.float32(acc + read(t))
                if m_out == 1:
                    dst[srow[s], c] = acc
                else:
                    out[s + q, c] = acc
        kpow *= k
        if kpow >= n:
            break
        level += 1
    return torch.from_numpy(dst)


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


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_rows,c", [(262_144, 4, 3), (262_144, 100_000, 3),
                                        (33, 5, 18), (1, 1, 1)])
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
