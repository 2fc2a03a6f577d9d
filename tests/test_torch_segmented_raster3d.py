"""The segment-parallel 3DGS blend (K5/K6, csrc/raster3d.cu) as an
algorithm, on the CPU: ``blend3d_segments_plain`` (the plain emulation of
K5's unit products, segment walks from T_in and in-order fold) and
``blend3d_bwd_segments_plain`` (K6's items from the closed-form suffix)
at segments of 8, 64 and 256 pairs, so that 48x64 views have many
segments, against the plain walk ``blend3d_plain``, its autograd VJP and
the JAX package's ``rasterize_3dgs``; the fold's decisions forced through
``t_of``; the kernels' per-warp cull (``warp_refuses_plain``, the same
directed roundings) on a seeded sweep with pairs at the 1/255 edge; the
threshold band of ``compare_blend3d``; and ``blend3d_plain(decisions=
True)``.

Tolerances: K5's state as ``compare_blend3d`` judges it (T and colour
sums 2e-5, depth sums 2e-4, the work counts exact, every flip of one pair
within the band; T on tiles of one segment to 1e-6 here, since the CPU's
torch.cumprod multiplies float32 in float64, bitwise on the card); images
against JAX to 2e-5 (image, alpha) and 2e-4 (depth), as
tests/test_torch_raster3d.py; gradients max-normalised rtol 2e-4 atol
2e-5 against the plain VJP and 2e-4 against JAX (the repo's gradient
tolerances)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.config import RasterConfig as JRasterConfig
from d2dgs_tpu.data.cameras import orbit_camera as jorbit
from d2dgs_tpu.ops import raster3d as j3
from d2dgs_torch.config import T_CUTOFF, RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.data.synthetic import blend_test_scene
from d2dgs_torch.ops import raster3d as t3
from d2dgs_torch.ops.cuda import raster3d as k3
from d2dgs_torch.ops.projection import tile_grid
from d2dgs_torch.ops.tiled_raster import PIX, tiles_to_image

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)

H, W = 48, 64
CAM = dict(azimuth=0.4, elevation=0.3, radius=3.0, fov=0.8, H=H, W=W)
TILE_CAP = 1024          # above the packed scene's busiest tile (655)
GRAD = dict(rtol=2e-4, atol=2e-5)
SINGLE_TOL = 1e-6        # T on tiles of one segment, on the CPU
SEGS = [8, 64, 256]


def _arrays(kind):
    """A check scene of ``blend_test_scene``; "packed_opaque" is the packed
    scene at opacity 0.999."""
    arrs = list(blend_test_scene("packed" if kind == "packed_opaque"
                                 else kind))
    if kind == "packed_opaque":
        arrs[3] = np.full_like(arrs[3], 0.999)
    return arrs


def _args(kind, tile_cap=TILE_CAP, chunk=64):
    """blend3d_plain's arguments for a check scene, and the camera."""
    cam = orbit_camera(**CAM, device="cpu")
    xs = [torch.from_numpy(a) for a in _arrays(kind)]
    _, args = t3.blend3d_inputs(*xs, cam, cfg=RasterConfig(
        tile_cap=tile_cap, chunk=chunk))
    return args, cam


def _judge(args, seg, t_of=None):
    """The emulated forward at ``seg`` judged against the plain walk:
    (compare_blend3d's result, the emulation's outputs)."""
    emu = k3.blend3d_segments_plain(*args, seg=seg, t_of=t_of)
    *plain, dec = t3.blend3d_plain(*args, decisions=True)
    pairs = torch.clamp(args[7], max=k3.walk_cap(args[9], args[10]))
    res = k3.compare_blend3d(emu[0], emu[2], plain, dec, pairs, seg=seg,
                             single_tol=SINGLE_TOL)
    return res, emu


def _assert_judged(res):
    shown = {k: v for k, v in res.items() if k != "flip_mask"}
    assert res["ok"], shown
    assert res["flipped"] == res["in_band"], shown


@pytest.fixture(scope="module")
def jax_images():
    """JAX rasterize_3dgs of each check scene (image, depth, alpha) on a
    background of 0, at tile_cap TILE_CAP."""
    cache = {}

    def get(kind, tile_cap=TILE_CAP, chunk=64):
        key = (kind, tile_cap, chunk)
        if key not in cache:
            cfg = JRasterConfig(tile_cap=tile_cap, chunk=chunk,
                                pair_cap=4096, use_pallas=False)
            img, _, depth, alpha = jax.jit(lambda *a: j3.rasterize_3dgs(
                *a, cam=jorbit(**CAM), cfg=cfg))(
                *map(jnp.asarray, _arrays(kind)))
            cache[key] = [np.asarray(x) for x in (img, depth, alpha)]
        return cache[key]
    return get


def _against_jax(state, flip, j):
    """The emulated state's images against JAX's, outside the flipped
    pixels."""
    gx, gy = tile_grid(H, W)
    out = t3.blend3d_images(*state, torch.zeros(3), H, W)
    keep = ~tiles_to_image(flip[..., None], gx, gy, H, W)[..., 0].numpy()
    for x, y, tol in zip(out, j, (2e-5, 2e-4, 2e-5)):
        np.testing.assert_allclose(x.numpy()[keep], y[keep], rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("kind", ["pallas", "opaque", "packed"])
def test_emulated_forward_matches_plain_and_jax(kind, seg, jax_images):
    """K5's algorithm at ``seg`` against blend3d_plain (values, exact work
    counts, every flip in the band) and against JAX's images; the scenes
    have tiles of many segments."""
    args, _ = _args(kind)
    res, emu = _judge(args, seg)
    _assert_judged(res)
    assert res["multi_segment_tiles"] > 0 or seg == 256
    _against_jax(emu[0], res["flip_mask"], jax_images(kind))


def test_termination_in_a_middle_segment():
    """The opaque packed scene at 8-pair segments: pixels terminate inside
    segments that are neither the first nor the last of their tile, and
    the emulation still agrees with the plain walk."""
    args, _ = _args("packed_opaque")
    res, (state, n_walk, work, _) = _judge(args, 8)
    _assert_judged(res)
    counts = torch.clamp(args[7], max=TILE_CAP).long()[:, None]
    trip_seg = (work[:, 0].long() - 1) // 8
    middle = (state[0] <= T_CUTOFF) & (trip_seg > 0) \
        & (trip_seg < (counts - 1) // 8)
    assert int(middle.sum()) > 100


def test_fold_stops_at_the_trip():
    """Pixels that terminated in an earlier segment are handed T_in = 1 in
    the later ones (as if rounding had left them alive): their later walks
    blend pairs, and the fold, which stops at the first segment that
    reports done, still gives the plain walk's state."""
    args, _ = _args("packed_opaque")
    forced = []

    def lift(t):
        forced.append(int((t <= T_CUTOFF).sum()))
        return torch.where(t <= T_CUTOFF, 1.0, t)
    res, _ = _judge(args, 64, t_of=lift)
    _assert_judged(res)
    assert forced[0] > 1000


def test_segment_entered_below_the_cutoff_without_a_trip():
    """Every segment after a tile's first is entered with T_in = 0 (as if
    rounding had taken a live pixel below the cutoff): no segment's own
    walk runs, and the fold walks each on from its running T, as the
    sequential walk would; the state and the work counts are the plain
    walk's."""
    args, _ = _args("packed")

    def drop(t):
        return torch.cat([t[:, :1], torch.zeros_like(t[:, 1:])], dim=1)
    for seg in (8, 64):
        res, _ = _judge(args, seg, t_of=drop)
        _assert_judged(res)
        assert res["multi_segment_tiles"] > 0


@pytest.mark.parametrize("seg", [64, 256])
def test_every_pixel_done_before_the_last_segment(seg):
    """The wall scene: every tile holds 600 pairs (3 segments of 256, 10 of
    64) and every pixel terminates before its tile's last segment.  The
    forward agrees with the plain walk, and the backward's later items,
    past each tile's walk, exit at once: it agrees with the plain VJP."""
    args, _ = _args("wall")
    res, emu = _judge(args, seg)
    _assert_judged(res)
    state, n_walk, work, _ = emu
    counts = torch.clamp(args[7], max=TILE_CAP).long()
    multi = counts > seg
    assert bool(multi.any())
    last_start = (counts[multi] - 1) // seg * seg
    assert bool((state[0][multi] <= T_CUTOFF).all())
    assert bool((n_walk[multi].long() <= last_start[:, None]).all())
    g = [torch.randn(o.shape, generator=torch.Generator().manual_seed(2))
         for o in state]
    dk = k3.blend3d_bwd_segments_plain(*args[:9], *g, seg=seg,
                                       tile_cap=TILE_CAP, forward=emu)
    dp = k3.blend3d_plain_vjp(*args[:9], *g, tile_cap=TILE_CAP)
    for a, b in zip(dk, dp):
        scale = b.abs().max() + 1e-8
        torch.testing.assert_close(a / scale, b / scale, **GRAD)


@pytest.mark.parametrize("seg", [8, 64])
@pytest.mark.parametrize("tile_cap, chunk", [(100, 32), (40, 64)])
def test_tile_cap_off_a_multiple_of_chunk(tile_cap, chunk, seg,
                                          jax_images):
    """At most walk_cap(chunk, tile_cap) pairs of a tile are walked (96 of
    tile_cap 100 at chunk 32; one chunk of 64 at tile_cap 40), on both
    the emulation and the plain walk, which agree, and as JAX walks."""
    args, _ = _args("packed", tile_cap, chunk)
    cap = k3.walk_cap(chunk, tile_cap)
    assert int(args[7].max()) > cap
    res, emu = _judge(args, seg)
    _assert_judged(res)
    assert int(emu[2][:, 0].max()) <= cap
    _against_jax(emu[0], res["flip_mask"],
                 jax_images("packed", tile_cap, chunk))


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("kind", ["pallas", "packed"])
def test_emulated_backward_matches_plain_vjp(kind, seg):
    """K6's algorithm at ``seg`` (closed-form suffix sums at each item's
    segment end) against the autograd VJP through blend3d_plain, on a
    cotangent from a seed."""
    args, _ = _args(kind)
    g = [torch.randn(s, generator=torch.Generator().manual_seed(7))
         for s in ((args[6].shape[0], PIX), (args[6].shape[0], PIX, 3),
                   (args[6].shape[0], PIX))]
    dk = k3.blend3d_bwd_segments_plain(*args[:9], *g, tile_cap=TILE_CAP,
                                       seg=seg)
    dp = k3.blend3d_plain_vjp(*args[:9], *g, tile_cap=TILE_CAP)
    for a, b in zip(dk, dp):
        scale = b.abs().max() + 1e-8
        assert float(scale) > 1e-6
        torch.testing.assert_close(a / scale, b / scale, **GRAD)


@pytest.mark.parametrize("seg", SEGS)
def test_emulated_backward_matches_jax_gradients(seg):
    """The emulated backward, carried back through preprocess3d by
    autograd, against JAX's gradients of rasterize_3dgs in the five scene
    inputs, max-normalised to 2e-4 (as tests/test_torch_raster3d.py)."""
    arrs = _arrays("pallas")
    jcfg = JRasterConfig(tile_cap=TILE_CAP, chunk=64, pair_cap=4096,
                         use_pallas=False)
    w = np.random.RandomState(8).uniform(size=(H, W, 5)).astype(np.float32)

    def jloss(*a):
        img, _, depth, alpha = j3.rasterize_3dgs(*a, jorbit(**CAM), cfg=jcfg)
        return jnp.sum(jnp.concatenate([img, depth, alpha], -1) * w)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, arrs))
    cam = orbit_camera(**CAM, device="cpu")
    xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
    _, args = t3.blend3d_inputs(*xs, cam, cfg=RasterConfig(
        tile_cap=TILE_CAP))
    plain = [a.detach() if torch.is_tensor(a) else a for a in args]
    emu = k3.blend3d_segments_plain(*plain, seg=seg)
    state = [t.detach().requires_grad_() for t in emu[0]]
    img, depth, alpha = t3.blend3d_images(*state, torch.zeros(3), H, W)
    cot = torch.autograd.grad(torch.sum(torch.cat([img, depth, alpha], -1)
                                        * torch.from_numpy(w)), state)
    d_blend = k3.blend3d_bwd_segments_plain(*plain[:9], *cot,
                                            tile_cap=TILE_CAP, seg=seg,
                                            forward=emu)
    tg = torch.autograd.grad(args[:5], xs, d_blend)
    for name, a, b in zip(("means", "scales", "quats", "opac", "colors"),
                          tg, jg):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def _sweep(n, seed):
    """``n`` seeded pairs around one warp's pixels (x in [x0, x0 + 15], y
    in [y0, y0 + 1] at x0 = 32, y0 = 18): conics of low-passed random
    covariances (preprocess3d adds 0.3 to the diagonal), centres within
    30 px, and opacities that put the warp's largest alpha within 1e-6 of
    1/255 for every third pair, random in (0, 1) otherwise."""
    rs = np.random.RandomState(seed)
    x0, y0 = 32.0, 18.0
    ang = rs.uniform(0, np.pi, n)
    s1, s2 = np.exp(rs.uniform(-1, 4, (2, n)))
    c, s = np.cos(ang), np.sin(ang)
    cxx = c * c * s1 + s * s * s2 + 0.3
    cyy = s * s * s1 + c * c * s2 + 0.3
    cxy = c * s * (s1 - s2)
    det = cxx * cyy - cxy * cxy
    conic = np.stack([cyy / det, -cxy / det, cxx / det], -1)
    center = np.stack([x0 + rs.uniform(-30, 45, n),
                       y0 + rs.uniform(-30, 31, n)], -1)
    conic, center = conic.astype(np.float32), center.astype(np.float32)
    # an edge pair's conic is scaled so that its largest power over the
    # warp is -ln(255 o) for an opacity o in (0.005, 1), then o is set from
    # the float32 power the plain walk computes there
    xs, ys = np.meshgrid(np.arange(16.0), np.arange(2.0))
    d = torch.from_numpy((np.stack([x0 + xs.ravel(), y0 + ys.ravel()], -1)
                          [None] - center[:, None]).astype(np.float32))

    def power_at(con):
        con = torch.from_numpy(con)[:, None]
        return (-0.5 * (con[..., 0] * d[..., 0] ** 2 + con[..., 2]
                        * d[..., 1] ** 2) - con[..., 1] * d[..., 0]
                * d[..., 1]).numpy().astype(np.float64).max(axis=1)
    edge = np.arange(n) % 3 == 0
    target = -np.log(255.0 * rs.uniform(0.005, 1.0, n))
    scale = np.where(edge, target / np.minimum(power_at(conic), -1e-3), 1.0)
    conic = (conic * scale[:, None]).astype(np.float32)
    with np.errstate(over="ignore"):       # the non-edge pairs' far pixels
        at_edge = np.exp(-power_at(conic)) / 255.0 \
            * (1.0 + rs.uniform(-1e-6, 1e-6, n))
    opac = np.where(edge, at_edge, rs.uniform(0, 1, n))
    return conic, center, np.clip(opac, 0.0, 1.0).astype(np.float32), x0, y0


def test_cull_never_refuses_a_kept_pair():
    """The kernels' per-warp cull (warp_refuses_plain: the same directed
    roundings, exactly) and per-pixel cull (power below the pair's cull
    power) on a seeded sweep of 30,000 pairs, a third of them at the 1/255
    edge at one pixel of the warp: neither refuses a pair that the plain
    walk's alpha keeps at any of the warp's 32 pixels, and the warp test
    refuses most of the pairs that no pixel keeps."""
    n = 30_000
    conic, center, opac, x0, y0 = _sweep(n, seed=4)
    cut = k3.cull_power_plain(torch.from_numpy(opac))
    refused = k3.warp_refuses_plain(conic, center, cut.numpy(),
                                    np.full(n, x0), np.full(n, y0))
    xs, ys = np.meshgrid(np.arange(16.0), np.arange(2.0))
    pix = torch.from_numpy(np.stack([x0 + xs.ravel(), y0 + ys.ravel()],
                                    -1).astype(np.float32))        # [32, 2]
    d = pix[None] - torch.from_numpy(center)[:, None]               # [n,32,2]
    con = torch.from_numpy(conic)[:, None]
    power = (-0.5 * (con[..., 0] * d[..., 0] ** 2 + con[..., 2]
                     * d[..., 1] ** 2) - con[..., 1] * d[..., 0] * d[..., 1])
    alpha = t3.alpha3d(d[:, None], con, torch.from_numpy(opac)[:, None])
    kept = (alpha[:, 0] > 0).numpy()                                # [n,32]
    assert not (refused[:, None] & kept).any()
    assert not ((power < cut[:, None]) & (alpha[:, 0] > 0)).any()
    edge = np.arange(n) % 3 == 0
    assert 0.2 < kept[edge].any(axis=1).mean() < 0.8   # the edge is reached
    assert (~kept[edge].any(axis=1)).any()
    none_kept = ~kept.any(axis=1)
    assert refused[none_kept].mean() > 0.5
    assert refused.mean() > 0.2


def test_band_judges_flips():
    """compare_blend3d on made-up states: a pixel that blends one pair more
    than the plain walk, whose plain T lies 1 ulp of T_CUTOFF away after
    10 pairs, is in the band; 30 ulps away after 10 pairs, or two pairs
    more, it is outside, and ``ok`` fails; a colour error on an unflipped
    pixel fails too."""
    nt = 2
    T = torch.full((nt, PIX), 0.5)
    C = torch.zeros((nt, PIX, 3))
    D = torch.zeros((nt, PIX))
    dec = torch.zeros((nt, 3, PIX))
    dec[:, 0], dec[:, 1], dec[:, 2] = 0.6, 20.0, 10.0
    work = torch.zeros((nt, 2, PIX), dtype=torch.int32)
    work[:, 0], work[:, 1] = 20, 10
    pairs = torch.tensor([300, 300])
    ulp = k3.ULP_CUTOFF

    def judged(t_plain, extra, colour_err=0.0):
        Tp = T.clone()
        Tp[1, 5] = t_plain
        wk = work.clone()
        wk[1, 1, 5] += extra
        Ck = C.clone()
        Ck[0, 7, 1] += colour_err
        return k3.compare_blend3d((T, Ck, D), wk, (Tp, C, D), dec, pairs)
    near = judged(T_CUTOFF + ulp, 1)
    assert near["ok"] and near["flipped"] == near["in_band"] == 1
    assert near["band_max_pairs"] == 10.0 and near["band_max_ulps"] < 1.5
    assert not judged(T_CUTOFF + 30 * ulp, 1)["ok"]
    assert not judged(T_CUTOFF + ulp, 2)["ok"]
    assert not judged(T_CUTOFF + ulp, 1, colour_err=1e-3)["ok"]


@pytest.mark.parametrize("kind", ["opaque", "packed"])
def test_blend3d_plain_decisions(kind):
    """blend3d_plain(decisions=True) leaves its state bitwise as without;
    its counts are the emulation's, and a pixel's T before its last
    blended pair lies above the cutoff (the walk blends only while T >
    T_CUTOFF) and is NaN where it blended none."""
    args, _ = _args(kind)
    *state, dec = t3.blend3d_plain(*args, decisions=True)
    for a, b in zip(state, t3.blend3d_plain(*args)):
        assert torch.equal(a, b)
    work = k3.blend3d_segments_plain(*args, seg=256)[2]
    assert torch.equal(dec[:, t3.DEC3_EVAL:].to(torch.int32), work)
    blended = dec[:, t3.DEC3_BLEND] > 0
    assert bool((dec[:, t3.DEC3_T][blended] > T_CUTOFF).all())
    assert bool(torch.isnan(dec[:, t3.DEC3_T][~blended]).all())
    assert bool(blended.any()) and bool((~blended).any())
