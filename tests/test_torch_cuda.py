"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports torch, numpy and d2dgs_torch only, so it also
runs on a GPU machine without JAX; there, skip the suite's conftest (it
configures JAX) and the xdist options of pytest.ini:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""

Every test skips where torch.cuda.is_available() is False."""
import pytest
import torch

from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.data.synthetic import blend_test_scene
from d2dgs_torch.ops.binning import bin_gaussians
from d2dgs_torch.ops.cuda.blend import (DEAD_ROWS, BlendTiles, blend_bwd,
                                       blend_fwd, blend_tiles_plain_vjp)
from d2dgs_torch.ops.dense_raster import rasterize_dense
from d2dgs_torch.ops.projection import preprocess, tile_grid
from d2dgs_torch.ops.tiled_raster import (ROW_DONE, ROW_N_EVAL, ROW_T,
                                          blend_tiles_plain, pack_features,
                                          rasterize_tiled)

IMG = dict(rtol=1e-5, atol=1e-5)      # T, done and colour rows; the image
AUX = dict(rtol=1e-4, atol=1e-5)      # the other state rows; the allmap
# feature gradients, max-normalised per column: the tolerance of the JAX
# package's kernel gradients (tests/test_pallas_blend.py); it also absorbs
# the run-to-run order of K2's atomic sums
GRAD = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _scene(opaque, dev, packed=False):
    """48x64 view of 160 random splats (the shapes of
    tests/test_pallas_blend.py), optionally all at opacity 0.999; or the
    packed scene, whose busiest tile walks more than two 256-pair backward
    segments (``blend_test_scene``)."""
    kind = "packed" if packed else "opaque" if opaque else "pallas"
    cam = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=48, W=64, device=dev)
    return cam, [torch.as_tensor(a, device=dev)
                 for a in blend_test_scene(kind)]


def _kernel_args(cam, means, scales, quats, opac, colors):
    gx, gy = tile_grid(cam.H, cam.W)
    prep = preprocess(means, scales, quats, cam)
    op = torch.where(prep.valid, opac, 0.0)
    b = bin_gaussians(prep, gx, gy, RasterConfig(), opacity=op)
    feats = pack_features(prep.T, prep.center, prep.normal, colors, op)
    return (feats[b.order.long()].contiguous(), b.pair_rank, b.tile_start,
            b.tile_count, gx)


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True], ids=["pallas", "opaque"])
def test_blend_kernel_matches_plain_on_gpu(cuda, opaque):
    """The blend kernel vs blend_tiles_plain on the same CUDA inputs, and
    the tiled render on the card vs the dense oracle on the card."""
    cam, arrs = _scene(opaque, cuda)
    args = _kernel_args(cam, *arrs)
    before = blend_fwd.launches
    sk = blend_fwd(*args)
    torch.cuda.synchronize()
    assert blend_fwd.launches == before + 1
    sp = blend_tiles_plain(*args)
    img = [ROW_T, ROW_DONE, 4, 5, 6]
    aux = [r for r in range(ROW_N_EVAL) if r not in img]
    torch.testing.assert_close(sk[:, img], sp[:, img], **IMG)
    torch.testing.assert_close(sk[:, aux], sp[:, aux], **AUX)
    torch.testing.assert_close(sk[:, ROW_N_EVAL:], sp[:, ROW_N_EVAL:],
                               rtol=0, atol=0)
    if opaque:
        assert float(sk[:, ROW_DONE].sum()) > 0, "no early termination"

    bg = torch.tensor([0.2, 0.1, 0.4], device=cuda)
    ct, at, *_ = rasterize_tiled(*arrs, cam, bg)
    cd, ad, *_ = rasterize_dense(*arrs, cam, bg)
    torch.testing.assert_close(ct, cd, **IMG)
    torch.testing.assert_close(at, ad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True], ids=["pallas", "opaque"])
def test_blend_backward_matches_plain_vjp_on_gpu(cuda, opaque):
    """BlendTiles (K1 in training mode, then K2) against the plain VJP
    (autograd through blend_tiles_plain) on the same CUDA inputs, with a
    cotangent from a seed on every state row."""
    cam, arrs = _scene(opaque, cuda)
    fs, rank, start, count, gx = _kernel_args(cam, *arrs)
    f = fs.clone().requires_grad_()
    before = (blend_fwd.launches, blend_bwd.launches)
    state = BlendTiles.apply(f, rank, start, count, gx)
    g = torch.randn(state.shape, generator=torch.Generator().manual_seed(3))
    g = g.to(cuda)
    d_kernel, = torch.autograd.grad(state, f, g)
    torch.cuda.synchronize()
    assert (blend_fwd.launches, blend_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    # training mode leaves the state rows as serving computes them
    torch.testing.assert_close(state, blend_fwd(fs, rank, start, count, gx),
                               rtol=0, atol=0)
    d_plain = blend_tiles_plain_vjp(fs, rank, start, count, gx, g)
    scale = d_plain.abs().amax(dim=0) + 1e-8
    torch.testing.assert_close(d_kernel / scale, d_plain / scale, **GRAD)
    # the cotangents of the dead rows are ignored
    g_live = g.clone()
    g_live[:, list(DEAD_ROWS)] = 0.0
    d_live, = torch.autograd.grad(
        BlendTiles.apply(f, rank, start, count, gx), f, g_live)
    torch.testing.assert_close(d_live / scale, d_kernel / scale, **GRAD)


@pytest.mark.cuda
def test_blend_wrapper_refuses_bad_inputs(cuda):
    cam, arrs = _scene(False, cuda)
    fs, rank, start, count, gx = _kernel_args(cam, *arrs)
    # a CUDA input that requires grad goes through the forward kernel and,
    # on backward, the backward kernel
    f = fs.clone().requires_grad_()
    before = (blend_fwd.launches, blend_bwd.launches)
    state = BlendTiles.apply(f, rank, start, count, gx)
    assert blend_fwd.launches == before[0] + 1
    state[:, 4].sum().backward()
    assert blend_bwd.launches == before[1] + 1
    assert bool(torch.isfinite(f.grad).all())
    records = torch.empty((start.shape[0], 2, 256), dtype=torch.int32,
                          device=cuda)
    with pytest.raises(ValueError, match="records"):
        blend_fwd(fs, rank, start, count, gx, records=records[:, :1])
    with pytest.raises(ValueError, match="g_state"):
        blend_bwd(fs, rank, start, count, gx, state.detach(), records,
                  state.detach()[:-1].contiguous())
    with pytest.raises(TypeError, match="pair_rank"):
        blend_fwd(fs, rank.long(), start, count, gx)
    with pytest.raises(ValueError, match="tile_count"):
        blend_fwd(fs, rank, start, count.cpu(), gx)
    with pytest.raises(ValueError, match="contiguous"):
        blend_fwd(fs.t().contiguous().t(), rank, start, count, gx)


def _dense_args(cam, means, scales, quats, opac, colors, tile_cap):
    """The dense route's inputs (K3/K4) for one view, and the binning's
    pair count, which sizes K3's work as the render path sizes it."""
    from d2dgs_torch.ops.cuda.blend_dense import build_gdata
    gx, gy = tile_grid(cam.H, cam.W)
    prep = preprocess(means, scales, quats, cam)
    op = torch.where(prep.valid, opac, 0.0)
    b = bin_gaussians(prep, gx, gy, RasterConfig(), opacity=op)
    feats = pack_features(prep.T, prep.center, prep.normal, colors, op)
    gdata, counts = build_gdata(feats, b, tile_cap)
    return gdata, counts, gx, b.pair_rank.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("tile_cap", [256, 32], ids=["cap256", "cap32"])
@pytest.mark.parametrize("opaque", [False, True], ids=["pallas", "opaque"])
def test_dense_kernels_match_plain_on_gpu(cuda, opaque, tile_cap):
    """K3 against blend_dense_plain and K4 (through BlendTilesDense)
    against blend_dense_plain_vjp on the same CUDA inputs; a tile_cap of
    32 truncates the busiest tiles.  K3's state equals K1's on the same
    clamped pair lists (shared device code)."""
    from d2dgs_torch.ops.cuda.blend_dense import (BlendTilesDense,
                                                  blend_dense_bwd,
                                                  blend_dense_fwd,
                                                  blend_dense_plain,
                                                  blend_dense_plain_vjp)
    cam, arrs = _scene(opaque, cuda)
    gdata, counts, gx, n_pairs = _dense_args(cam, *arrs, tile_cap)
    before = blend_dense_fwd.launches
    sk = blend_dense_fwd(gdata, counts, gx, max_pairs=n_pairs)
    torch.cuda.synchronize()
    assert blend_dense_fwd.launches == before + 1
    sp = blend_dense_plain(gdata, counts, gx)
    img = [ROW_T, ROW_DONE, 4, 5, 6]
    aux = [r for r in range(ROW_N_EVAL) if r not in img]
    torch.testing.assert_close(sk[:, img], sp[:, img], **IMG)
    torch.testing.assert_close(sk[:, aux], sp[:, aux], **AUX)
    torch.testing.assert_close(sk[:, ROW_N_EVAL:], sp[:, ROW_N_EVAL:],
                               rtol=0, atol=0)
    fs, rank, start, count, _ = _kernel_args(cam, *arrs)
    k1 = blend_fwd(fs, rank, start, torch.clamp_max(count, tile_cap), gx)
    torch.testing.assert_close(sk, k1, rtol=0, atol=0)

    f = gdata.clone().requires_grad_()
    before = (blend_dense_fwd.launches, blend_dense_bwd.launches)
    state = BlendTilesDense.apply(f, counts, gx, n_pairs)
    g = torch.randn(state.shape, generator=torch.Generator().manual_seed(3))
    g = g.to(cuda)
    d_kernel, = torch.autograd.grad(state, f, g)
    torch.cuda.synchronize()
    assert (blend_dense_fwd.launches, blend_dense_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(state, sk, rtol=0, atol=0)
    d_plain = blend_dense_plain_vjp(gdata, counts, gx, g)
    scale = d_plain.abs().amax(dim=(0, 1)) + 1e-8
    torch.testing.assert_close(d_kernel / scale, d_plain / scale, **GRAD)
    past = torch.arange(tile_cap, device=cuda)[None, :] >= counts[:, None]
    assert not bool(d_kernel[past].any())
    with pytest.raises(ValueError, match="counts"):
        blend_dense_fwd(gdata, counts[:-1], gx, max_pairs=n_pairs)
    with pytest.raises(TypeError, match="gdata"):
        blend_dense_fwd(gdata.double(), counts, gx, max_pairs=n_pairs)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wq", "dense"])
def test_segmented_backward_on_packed_scene(cuda, route):
    """The packed scene, whose busiest tile spans three backward
    segments: K1/K3 in training mode write the plain forward walk's
    records and checkpoints (and the serving state), and K2/K4 from them
    match their plain versions."""
    from d2dgs_torch.ops.cuda.blend import (NREC, SEG, pack_checkpoints,
                                            segment_layout)
    from d2dgs_torch.ops.cuda.blend_dense import (BlendTilesDense,
                                                  blend_dense_bwd,
                                                  blend_dense_fwd,
                                                  blend_dense_plain_vjp)
    from d2dgs_torch.ops.tiled_raster import CKPT_ROWS, PIX, blend_walk
    cam, arrs = _scene(False, cuda, packed=True)
    gdata, counts, gx, n_pairs = _dense_args(cam, *arrs, 1024)
    fs, rank, start, count, _ = _kernel_args(cam, *arrs)
    num_tiles = counts.shape[0]
    seg = segment_layout(counts)
    records = torch.empty((num_tiles, NREC, PIX), dtype=torch.int32,
                          device=cuda)
    if route == "wq":
        args = (fs, rank, start, count, gx)
        state = blend_fwd(*args, records=records, segments=seg)
        serve = blend_fwd(*args)
    else:
        state = blend_dense_fwd(gdata, counts, gx, records=records,
                                segments=seg, max_pairs=n_pairs)
        serve = blend_dense_fwd(gdata, counts, gx, max_pairs=n_pairs)
    torch.cuda.synchronize()
    torch.testing.assert_close(state, serve, rtol=0, atol=0)
    cap = gdata.shape[1]
    lane = torch.arange(64, device=cuda)
    _, ck_plain, rec_plain = blend_walk(
        lambda c0: gdata[:, torch.clamp_max(c0 + lane, cap - 1)], counts, gx,
        64, torch.arange(num_tiles, device=cuda), checkpoints=SEG)
    n_walk = int(records[:, 0].max()) + 1
    assert n_walk > 2 * SEG, "the scene must span three segments"
    torch.testing.assert_close(records[:, 0], rec_plain[:, 0], rtol=0,
                               atol=0)
    assert int((records[:, 1] != rec_plain[:, 1]).sum()) <= 2
    ck = pack_checkpoints(ck_plain, seg)
    for r in range(len(CKPT_ROWS)):
        tol = IMG if CKPT_ROWS[r] in (0, 4, 5, 6) else AUX
        torch.testing.assert_close(seg.ckpt[:, r], ck[:, r], **tol)

    g = torch.randn(state.shape, generator=torch.Generator().manual_seed(3))
    g = g.to(cuda)
    if route == "wq":
        f = fs.clone().requires_grad_()
        before = blend_bwd.launches
        d_kernel, = torch.autograd.grad(BlendTiles.apply(f, rank, start,
                                                         count, gx), f, g)
        torch.cuda.synchronize()
        assert blend_bwd.launches == before + 1
        d_plain = blend_tiles_plain_vjp(fs, rank, start, count, gx, g)
        scale = d_plain.abs().amax(dim=0) + 1e-8
    else:
        f = gdata.clone().requires_grad_()
        before = blend_dense_bwd.launches
        d_kernel, = torch.autograd.grad(
            BlendTilesDense.apply(f, counts, gx, n_pairs), f, g)
        torch.cuda.synchronize()
        assert blend_dense_bwd.launches == before + 1
        d_plain = blend_dense_plain_vjp(gdata, counts, gx, g)
        scale = d_plain.abs().amax(dim=(0, 1)) + 1e-8
        past = torch.arange(cap, device=cuda)[None, :] >= counts[:, None]
        assert not bool(d_kernel[past].any())
    torch.testing.assert_close(d_kernel / scale, d_plain / scale, **GRAD)


@pytest.mark.cuda
def test_kernels_refuse_other_segment_length(cuda):
    """A layout at another segment length than the kernels' SEG fits its
    own items' shapes, but every training entry point refuses it before
    launching: K1/K3 would write checkpoints past their tile's run."""
    from d2dgs_torch.ops.cuda.blend import NREC, SEG, segment_layout
    from d2dgs_torch.ops.cuda.blend_dense import (blend_dense_bwd,
                                                  blend_dense_fwd)
    from d2dgs_torch.ops.tiled_raster import PIX
    cam, arrs = _scene(False, cuda, packed=True)
    gdata, counts, gx, n_pairs = _dense_args(cam, *arrs, 1024)
    fs, rank, start, count, _ = _kernel_args(cam, *arrs)
    records = torch.empty((counts.shape[0], NREC, PIX), dtype=torch.int32,
                          device=cuda)
    state = blend_fwd(fs, rank, start, count, gx)
    g = torch.zeros_like(state)
    launches = (blend_fwd.launches, blend_bwd.launches,
                blend_dense_fwd.launches, blend_dense_bwd.launches)
    for seg in (SEG // 2, 2 * SEG):
        lay = segment_layout(counts, seg)
        with pytest.raises(ValueError, match=f"{seg}-pair segments"):
            blend_fwd(fs, rank, start, count, gx, records=records,
                      segments=lay)
        with pytest.raises(ValueError, match=f"{seg}-pair segments"):
            blend_bwd(fs, rank, start, count, gx, state, records, g, lay)
        with pytest.raises(ValueError, match=f"{seg}-pair segments"):
            blend_dense_fwd(gdata, counts, gx, records=records, segments=lay,
                            max_pairs=n_pairs)
        with pytest.raises(ValueError, match=f"{seg}-pair segments"):
            blend_dense_bwd(gdata, counts, gx, state, records, g, lay)
    assert (blend_fwd.launches, blend_bwd.launches, blend_dense_fwd.launches,
            blend_dense_bwd.launches) == launches


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pallas", "opaque", "packed"])
@pytest.mark.parametrize("route", ["wq", "dense"])
def test_segmented_forward_matches_plain_on_gpu(cuda, route, kind):
    """K1/K3, one CTA per (tile, 256-pair segment) in two passes, against
    their plain versions in serving and in training mode, judged as
    compare_states judges (no flipped pixel at 48x64); training mode
    leaves the state as serving computes it and writes the records and
    checkpoints of the plain emulation of its algorithm; the first pass
    counts its evaluations and both passes time their units and items;
    the work lists the layout kernel builds on the card are the
    backward's items and ceil(count / UNIT) units per tile."""
    from d2dgs_torch.ops.cuda.blend import (NREC, UNIT,
                                            blend_fwd_segments_plain,
                                            compare_states, forward_layout,
                                            pack_checkpoints, segment_layout)
    from d2dgs_torch.ops.cuda.blend_dense import (blend_dense_fwd,
                                                  blend_dense_plain)
    from d2dgs_torch.ops.tiled_raster import CKPT_ROWS, PIX
    cam, arrs = _scene(kind == "opaque", cuda, packed=kind == "packed")
    gdata, counts, gx, n_pairs = _dense_args(cam, *arrs, 1024)
    fs, rank, start, count, _ = _kernel_args(cam, *arrs)
    if route == "wq":
        run = lambda **k: blend_fwd(fs, rank, start, count, gx, **k)
        plain = blend_tiles_plain(fs, rank, start, count, gx)
        launches = lambda: blend_fwd.launches
    else:
        run = lambda **k: blend_dense_fwd(gdata, counts, gx,
                                          max_pairs=n_pairs, **k)
        plain = blend_dense_plain(gdata, counts, gx)
        launches = lambda: blend_dense_fwd.launches
    seg = segment_layout(counts)
    records = torch.empty((counts.shape[0], NREC, PIX), dtype=torch.int32,
                          device=cuda)
    n_units = int((-(-counts.long() // UNIT)).sum())
    unit_ns = torch.zeros((n_units, 2), dtype=torch.int64, device=cuda)
    item_ns = torch.zeros((seg.items.shape[0], 2), dtype=torch.int64,
                          device=cuda)
    n_pass_a = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = launches()
    reports = ({}, {})
    serve = run(unit_ns=unit_ns, item_ns=item_ns, n_pass_a=n_pass_a,
                report=reports[0])
    state = run(records=records, segments=seg, report=reports[1])
    torch.cuda.synchronize()
    assert launches() == before + 2
    for rep in reports:
        items, units = forward_layout(rep)
        assert torch.equal(items, seg.items)
        assert torch.equal(torch.bincount(units[:, 0].long(),
                                          minlength=counts.shape[0]),
                           -(-counts.long() // UNIT))
        assert rep["grid_items"] >= items.shape[0]
        assert rep["grid_units"] >= units.shape[0]
    for st, mode in ((serve, "serving"), (state, "training")):
        res = compare_states(st, plain)
        assert res["flipped"] == 0 and res["bad_outside_flips"] == 0, (
            mode, res["row_max_abs_err"])
    torch.testing.assert_close(state, serve, rtol=0, atol=0)
    emu, ck_emu, rec_emu = blend_fwd_segments_plain(gdata, counts, gx,
                                                    train=True)
    torch.testing.assert_close(records, rec_emu, rtol=0, atol=0)
    ck = pack_checkpoints(ck_emu, seg)
    for r in range(len(CKPT_ROWS)):
        tol = IMG if CKPT_ROWS[r] in (0, 4, 5, 6) else AUX
        torch.testing.assert_close(seg.ckpt[:, r], ck[:, r], **tol)
    for ns in (unit_ns, item_ns):
        assert bool((ns[:, 1] >= ns[:, 0]).all())
        assert bool((ns[:, 0] > 0).all())
    # the first pass evaluates every pair of every pixel, up to its warps'
    # stops
    pairs = int(counts.long().sum())
    assert 0 < int(n_pass_a) <= pairs * PIX
    if kind == "packed":
        assert int(counts.max()) > 512


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True], ids=["pallas", "opaque"])
def test_rasterize_3dgs_on_gpu_matches_cpu(cuda, opaque):
    """The 3DGS flow rasterizer (plain torch) on the card against the
    same call on the CPU: radii bitwise, image and alpha to 2e-5, depth
    to 2e-4 (tests/test_torch_raster3d.py's tolerances), gradients of
    the five inputs max-normalised to GRAD."""
    from d2dgs_torch.ops.raster3d import rasterize_3dgs
    g = torch.Generator().manual_seed(3)
    n = 160
    means = torch.randn(n, 3, generator=g) * 0.5
    scales = torch.exp(torch.randn(n, 3, generator=g) * 0.3) * 0.1
    quats = torch.nn.functional.normalize(torch.randn(n, 4, generator=g),
                                          dim=-1)
    opac = (torch.full((n,), 0.99) if opaque
            else 0.3 + 0.6 * torch.rand(n, generator=g))
    colors = torch.rand(n, 3, generator=g)
    w = torch.rand(48, 64, 5, generator=g)
    cfg = RasterConfig(tile_cap=256, chunk=64)
    out = {}
    for dev in ("cpu", cuda):
        cam = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=48, W=64, device=dev)
        xs = [a.to(dev).requires_grad_(True)
              for a in (means, scales, quats, opac, colors)]
        img, radii, depth, alpha = rasterize_3dgs(*xs, cam, cfg=cfg)
        loss = torch.sum(torch.cat([img, depth, alpha], -1) * w.to(dev))
        grads = torch.autograd.grad(loss, xs)
        out[str(dev)] = [t.detach().cpu() for t in
                         (img, radii, depth, alpha, *grads)]
    c, d = out["cpu"], out["cuda"]
    assert torch.equal(c[1], d[1]) and int((c[1] > 0).sum()) > 100
    torch.testing.assert_close(d[0], c[0], rtol=0, atol=2e-5)
    torch.testing.assert_close(d[2], c[2], rtol=0, atol=2e-4)
    torch.testing.assert_close(d[3], c[3], rtol=0, atol=2e-5)
    for a, b in zip(d[4:], c[4:]):
        scale = b.abs().max()
        assert scale > 0
        torch.testing.assert_close(a / scale, b / scale, **GRAD)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pallas", "packed"])
def test_global_tile_map_on_gpu(cuda, kind):
    """K1 and K2 on interleaved slabs (every D-th tile, D = 2 and 3, slot
    s at grid tile gtile[s]), as the sharded render launches them: K1's
    state rows bitwise the whole-grid launch's rows of those tiles and
    within the tolerances of the plain version with the same map; K2
    against the plain VJP with the same map."""
    cam, arrs = _scene(False, cuda, packed=kind == "packed")
    fs, rank, start, count, gx = _kernel_args(cam, *arrs)
    whole = blend_fwd(fs, rank, start, count, gx)
    for D in (2, 3):
        for d in range(D):
            gtile = torch.arange(d, start.shape[0], D, dtype=torch.int32,
                                 device=cuda)
            sl = gtile.long()
            args = (fs, rank, start[sl].contiguous(),
                    count[sl].contiguous(), gx)
            before = blend_fwd.launches
            sk = blend_fwd(*args, gtile=gtile)
            torch.cuda.synchronize()
            assert blend_fwd.launches == before + 1
            torch.testing.assert_close(sk, whole[sl], rtol=0, atol=0)
            sp = blend_tiles_plain(*args, tile_ids=gtile)
            img = [ROW_T, ROW_DONE, 4, 5, 6]
            aux = [r for r in range(ROW_N_EVAL) if r not in img]
            torch.testing.assert_close(sk[:, img], sp[:, img], **IMG)
            torch.testing.assert_close(sk[:, aux], sp[:, aux], **AUX)
            f = fs.clone().requires_grad_()
            state = BlendTiles.apply(f, *args[1:], 64, gtile)
            g = torch.randn(state.shape,
                            generator=torch.Generator().manual_seed(d))
            g = g.to(cuda)
            d_kernel, = torch.autograd.grad(state, f, g)
            d_plain = blend_tiles_plain_vjp(*args, g, gtile=gtile)
            scale = d_plain.abs().amax(dim=0) + 1e-8
            torch.testing.assert_close(d_kernel / scale, d_plain / scale,
                                       **GRAD)


def _flow_blend_args(cam, means, scales, quats, opac, colors, cfg):
    """The arguments rasterize_3dgs hands its tile blend (K5/K6 or
    blend3d_plain) for a scene."""
    from d2dgs_torch.ops.raster3d import blend3d_inputs
    return blend3d_inputs(means, scales, quats, opac, colors, cam,
                          cfg=cfg)[1]


def _flow_scene(kind, dev):
    """A 48x64 check scene (``blend_test_scene``: "pallas", "opaque";
    "packed", whose busiest tiles hold 633 and 655 pairs, three 256-pair
    segments; "wall", whose 12 tiles hold 600 pairs each and where every
    pixel terminates in its first segment), or a full-width random one:
    800x800, 30,000 Gaussians of the phase-3 camera's scale."""
    if kind != "full":
        cam = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=48, W=64, device=dev)
        return cam, [torch.as_tensor(a, device=dev)
                     for a in blend_test_scene(kind)]
    g = torch.Generator().manual_seed(11)
    n = 30_000
    arrs = [torch.randn(n, 3, generator=g) * 0.6,
            torch.exp(torch.randn(n, 3, generator=g) * 0.3) * 0.02,
            torch.nn.functional.normalize(torch.randn(n, 4, generator=g),
                                          dim=-1),
            0.3 + 0.69 * torch.rand(n, generator=g),
            torch.rand(n, 3, generator=g) - 0.5]
    cam = orbit_camera(0.3, 0.25, 4.0, fov=0.69, H=800, W=800, device=dev)
    return cam, [a.to(dev) for a in arrs]


def _judge_k5(args, state, work):
    """K5's state and work rows against blend3d_plain's on the same CUDA
    inputs, judged by compare_blend3d: T bitwise on every tile of one
    256-pair segment, every flip of one pair within the threshold band,
    every other pixel within 2e-5 (T, colours) and 2e-4 (depth) with the
    same evaluated and blended pair counts.  Returns its result."""
    from d2dgs_torch.ops.cuda.raster3d import compare_blend3d, walk_cap
    from d2dgs_torch.ops.raster3d import blend3d_plain
    *plain, dec = blend3d_plain(*args, decisions=True)
    res = compare_blend3d(state, work, plain, dec,
                          torch.clamp(args[7], max=walk_cap(args[9],
                                                            args[10])))
    assert res["ok"], {k: v for k, v in res.items() if k != "flip_mask"}
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("tile_cap, chunk", [(4096, 64), (100, 32)],
                         ids=["cap4096", "cap100"])
@pytest.mark.parametrize("kind", ["pallas", "opaque", "packed", "wall",
                                  "full"])
def test_blend3d_kernels_match_plain_on_gpu(cuda, kind, tile_cap, chunk):
    """K5 against blend3d_plain on the same CUDA inputs (``_judge_k5``) in
    serving mode and, bitwise the same state, in training mode (Blend3D's
    forward); K6 (Blend3D's backward) against the autograd VJP through
    blend3d_plain on a cotangent from a seed, zero at the pixels K5's
    check judged flipped, each input's gradient max-normalised to GRAD;
    one launch of each wrapper per call.  tile_cap 100 at chunk 32 walks
    96 pairs of a tile."""
    from d2dgs_torch.config import T_CUTOFF
    from d2dgs_torch.ops.cuda.raster3d import (Blend3D, blend3d_bwd,
                                               blend3d_fwd,
                                               blend3d_plain_vjp)
    cam, arrs = _flow_scene(kind, cuda)
    args = _flow_blend_args(cam, *arrs, RasterConfig(tile_cap=tile_cap,
                                                     chunk=chunk))
    assert int(args[7].sum()) > 0
    nt = args[6].shape[0]
    work = torch.empty((nt, 2, 256), dtype=torch.int32, device=cuda)
    before = (blend3d_fwd.launches, blend3d_bwd.launches)
    served = blend3d_fwd(*args, work=work)
    torch.cuda.synchronize()
    assert blend3d_fwd.launches == before[0] + 1
    res = _judge_k5(args, served, work)
    if kind == "packed" and tile_cap == 4096:
        assert int(args[7].max()) > 512 and res["multi_segment_tiles"] >= 2
    if kind == "wall":               # every pixel ends in its first segment
        assert res["multi_segment_tiles"] == (nt if tile_cap == 4096 else 0)
        assert bool((served[0] <= T_CUTOFF).all())
        assert int(work[:, 0].max()) <= 256
    xs = [a.clone().requires_grad_() for a in args[:5]]
    out = Blend3D.apply(*xs, *args[5:])
    torch.cuda.synchronize()
    assert blend3d_fwd.launches == before[0] + 2
    for a, b in zip(out, served):
        assert torch.equal(a.detach(), b)
    gen = torch.Generator().manual_seed(5)
    g = [torch.randn(o.shape, generator=gen).to(cuda) for o in out]
    flip = res["flip_mask"]
    g = [torch.where(flip if t.dim() == 2 else flip[..., None], 0.0, t)
         for t in g]
    d_kernel = torch.autograd.grad(out, xs, g)
    torch.cuda.synchronize()
    assert blend3d_bwd.launches == before[1] + 1
    d_plain = blend3d_plain_vjp(*args[:9], *g, chunk=chunk,
                                tile_cap=tile_cap)
    for a, b in zip(d_kernel, d_plain):
        scale = b.abs().max() + 1e-8
        assert float(scale) > 1e-6
        torch.testing.assert_close(a / scale, b / scale, **GRAD)


@pytest.mark.cuda
def test_blend3d_kernels_on_an_empty_view(cuda):
    """No pair: rasterize_3dgs on the card renders the background, and
    its backward (K6) gives zero gradients."""
    from d2dgs_torch.ops.cuda.raster3d import blend3d_bwd
    from d2dgs_torch.ops.raster3d import rasterize_3dgs
    cam, arrs = _scene(False, cuda)
    arrs[0] = 1.5 * cam.cam_center[None] + 0.1 * arrs[0]   # behind it
    xs = [a.clone().requires_grad_() for a in arrs]
    bg = torch.tensor([0.2, 0.1, 0.4], device=cuda)
    before = blend3d_bwd.launches
    img, radii, depth, alpha = rasterize_3dgs(*xs, cam, bg=bg)
    grads = torch.autograd.grad(img.sum() + depth.sum() + alpha.sum(), xs,
                                allow_unused=True)
    assert blend3d_bwd.launches == before + 1
    assert torch.equal(img, bg.expand_as(img)) and not radii.any()
    assert not depth.any() and not alpha.any()
    assert all(g is None or not g.any() for g in grads)


@pytest.mark.cuda
def test_blend3d_wrappers_refuse_bad_inputs_on_gpu(cuda):
    """K5's and K6's wrappers raise on a CPU tensor among CUDA ones, a
    wrong dtype, a colour count the kernels are not built for and a walk
    laid out for another pair count."""
    from d2dgs_torch.ops.cuda.raster3d import (blend3d_bwd, blend3d_fwd,
                                               walk_buffers)
    cam, arrs = _scene(False, cuda)
    args = list(_flow_blend_args(cam, *arrs, RasterConfig()))
    with pytest.raises(ValueError, match="expected cuda"):
        blend3d_fwd(*args[:4], args[4].cpu(), *args[5:])
    with pytest.raises(TypeError, match="int32"):
        blend3d_fwd(*args[:5], args[5].long(), *args[6:])
    four = torch.cat([args[2], args[2][:, :1]], -1)
    with pytest.raises(ValueError, match="channels"):
        blend3d_fwd(*args[:2], four, *args[3:])
    nt = args[6].shape[0]
    T = torch.ones(nt, 256, device=cuda)
    state = (T, torch.zeros(nt, 256, 3, device=cuda), T)
    walk = walk_buffers(nt, args[5].shape[0], args[0].shape[0], cuda)
    with pytest.raises(ValueError, match="gC has shape"):
        blend3d_bwd(*args[:9], state, walk, T, T, T)
    with pytest.raises(ValueError, match="walk was laid out"):
        blend3d_bwd(*args[:9], state,
                    walk_buffers(nt, args[5].shape[0] + 256,
                                 args[0].shape[0], cuda), T,
                    state[1], T)


# ----------------------------------------------------------------------
# the node warp's gather (csrc/node_gather.cu)
# ----------------------------------------------------------------------

def _node_case(dev, m, c, n=200_000, k=3, live=83_252, dead_grad=False,
               seed=0):
    """node-train's shapes: n capacity rows, each bound to k of m nodes;
    the rows past ``live`` are dead: all bound to nodes 0..k-1, with a zero
    gradient as in a training step (``dead_grad``: a nonzero one)."""
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn((m, c), generator=gen)
    idx = torch.randint(0, m, (n, k), generator=gen)
    idx[live:] = torch.arange(k)
    g = torch.randn((n, k, c), generator=gen)
    if not dead_grad:
        g[live:] = 0.0
    return table.to(dev), idx.to(dev), g.to(dev)


def _rel_err(got, ref):
    """|got - ref| over |ref| (2-norms), in float64."""
    ref = ref.double()
    return float(torch.linalg.vector_norm(got.double() - ref)
                 / torch.linalg.vector_norm(ref))


def _sum64(idx, g, m):
    return torch.zeros((m, g.shape[-1]), dtype=torch.float64,
                       device=g.device).index_add_(
        0, idx.reshape(-1), g.reshape(-1, g.shape[-1]).double())


@pytest.mark.cuda
@pytest.mark.parametrize("dead_grad", [False, True], ids=["step", "pile"])
@pytest.mark.parametrize("c", [13, 18])
def test_node_gather_matches_plain_and_aten_on_gpu(cuda, c, dead_grad):
    """At node-train's shapes (200,000 x 3 rows into [1024, 13] and
    [1024, 18], 116,748 dead rows piled on three nodes): the forward
    bitwise aten's indexing; the backward (one launch of the kernels)
    within 1e-6 of the float64 sum,
    of the plain path and, where the pile's gradient is zero as in a step,
    of aten's indexing backward (whose serial float32 runs drift by ~1e-5
    over a pile of nonzero rows)."""
    from d2dgs_torch.ops.cuda.node_gather import (gather_bwd, gather_rows,
                                                  scatter_rows_plain)
    table, idx, g = _node_case(cuda, 1024, c, dead_grad=dead_grad)
    before = gather_bwd.launches
    t = table.clone().requires_grad_()
    out = gather_rows(t, idx)
    assert torch.equal(out, table[idx])
    grad, = torch.autograd.grad(out, t, g)
    torch.cuda.synchronize()
    assert gather_bwd.launches == before + 1
    assert _rel_err(grad, _sum64(idx, g, 1024)) <= 1e-6
    assert _rel_err(grad, scatter_rows_plain(g, idx, 1024)) <= 1e-6
    if not dead_grad:
        a = table.clone().requires_grad_()
        aten, = torch.autograd.grad(a[idx], a, g)
        assert _rel_err(grad, aten) <= 1e-6


@pytest.mark.cuda
def test_node_gather_backward_is_bitwise_reproducible(cuda):
    """Two backward calls on the same inputs give the same bits, and count
    the same rows: those whose gradient is not all zero."""
    from d2dgs_torch.ops.cuda.node_gather import gather_bwd
    _, idx, g = _node_case(cuda, 1024, 18, dead_grad=True)
    g[::7] = 0.0
    counts = [torch.zeros(1, dtype=torch.int64, device=cuda)
              for _ in range(2)]
    a = gather_bwd(g, idx, 1024, counts[0])
    b = gather_bwd(g, idx, 1024, counts[1])
    assert torch.equal(a, b)
    nonzero = int(torch.any(g != 0, dim=-1).sum())
    assert int(counts[0]) == int(counts[1]) == nonzero


@pytest.mark.cuda
@pytest.mark.parametrize("m, c, chunks", [(1024, 18, 1), (40_000, 3, 3)],
                         ids=["shared", "columns"])
def test_node_gather_routes_on_gpu(cuda, m, c, chunks):
    """The tile in shared memory whole, and split by columns across
    blockIdx.y where [m, c] does not fit a block.  Each against the float64
    sum, bitwise on a second call, and the count of accumulated rows."""
    from d2dgs_torch.ops.cuda.node_gather import bwd_plan, gather_bwd
    _, idx, g = _node_case(cuda, m, c, n=60_000, live=40_000,
                           dead_grad=True, seed=1)
    idx[:20_000] = torch.randint(0, m, (20_000, 3), device=cuda)
    g[30_000:35_000] = 0.0
    with torch.cuda.device(cuda):
        assert bwd_plan(idx.numel(), m, c)[1] == chunks
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    grad = gather_bwd(g, idx, m, count)
    assert _rel_err(grad, _sum64(idx, g, m)) <= 1e-6
    assert int(count) == int(torch.any(g != 0, dim=-1).sum())
    assert torch.equal(grad, gather_bwd(g, idx, m))


@pytest.mark.cuda
def test_node_gather_refuses_bad_inputs_on_gpu(cuda):
    """Other dtypes and devices, and a node count whose one column does
    not fit a block's shared memory, raise before any launch."""
    from d2dgs_torch.ops.cuda.node_gather import gather_bwd, gather_rows
    table, idx, g = _node_case(cuda, 64, 13, n=1000, live=900)
    with pytest.raises(TypeError, match="table"):
        gather_rows(table.double(), idx)
    with pytest.raises(TypeError, match="idx"):
        gather_rows(table, idx.int())
    with pytest.raises(ValueError, match="expected cuda"):
        gather_rows(table, idx.cpu())
    with pytest.raises(ValueError, match="expected cpu"):
        gather_rows(table.cpu(), idx)
    before = gather_bwd.launches
    with pytest.raises(ValueError, match="70000 nodes"):
        gather_bwd(g[..., :1].contiguous(), idx, 70_000)
    assert gather_bwd.launches == before


@pytest.mark.cuda
def test_node_gather_backward_drops_out_of_range_on_gpu(cuda):
    """An entry whose index lies outside [0, M) adds nothing and reads and
    writes nothing outside the tile: the result and the count are those of
    the in-range entries alone, on both routes."""
    from d2dgs_torch.ops.cuda.node_gather import gather_bwd
    for m, c in ((64, 13), (40_000, 3)):
        _, idx, g = _node_case(cuda, m, c, n=20_000, live=15_000,
                               dead_grad=True, seed=2)
        bad = idx.clone()
        bad[::5, 0] = m
        bad[1::5, 1] = -1
        keep = (bad >= 0) & (bad < m)
        count = torch.zeros(1, dtype=torch.int64, device=cuda)
        grad = gather_bwd(g, bad, m, count)
        ref = _sum64(bad[keep][:, None], g[keep][:, None], m)
        assert _rel_err(grad, ref) <= 1e-6
        assert int(count) == int(keep.sum())
