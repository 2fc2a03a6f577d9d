"""Hand-computed convention tests (the cases of tests/test_blend_hand_values
.py, docs/PARITY.md) run against the port: its dense oracle and its tiled
blend on the CPU.

Expected values come from the same independent numpy formulas,
transcribed from the reference kernel spec (forward.cu / auxiliary.h),
never from library code, so both of the port's renderers are pinned to
the written spec.  Tolerances are those of the JAX package's cases."""
import numpy as np
import pytest
import torch

from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import Camera
from d2dgs_torch.ops.dense_raster import rasterize_dense
from d2dgs_torch.ops.tiled_raster import rasterize_tiled

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)

H = W = 32
FX = FY = 40.0
ROUTES = ["dense", "tiled"]


def _identity_cam():
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    return Camera(w2c=torch.eye(4), cam_center=torch.zeros(3), fx=f(FX),
                  fy=f(FY), time=f(0.0), H=H, W=W)


def _render(route, means, scales, quats, opac, colors, bg=None):
    """(image [H,W,3], allmap [H,W,8], radii [N]) as numpy."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    args = (t(means), t(scales), t(quats), t(opac), t(colors),
            _identity_cam(), None if bg is None else t(bg))
    if route == "dense":
        img, allmap, radii, _ = rasterize_dense(*args)
    else:
        img, allmap, radii, *_ = rasterize_tiled(
            *args, cfg=RasterConfig(tile_cap=256, chunk=64))
    return img.numpy(), allmap.numpy(), radii.numpy()


def _splat(z=2.0, x=0.0, y=0.0, s=0.5, opacity=0.8):
    """A camera-facing surfel: tangent axes = (x, y), normal = +z."""
    return ([[x, y, z]], [[s, s]], [[1.0, 0, 0, 0]], [opacity])


def _stack(zs, s, opacity):
    n = len(zs)
    return ([[0.0, 0.0, z] for z in zs], np.full((n, 2), s),
            np.tile([[1.0, 0, 0, 0]], (n, 1)), np.full((n,), opacity))


def _hand_alpha(px, py, x, y, z, s, opacity):
    """Independent transcription of forward.cu:336-399 for an axis-aligned
    camera-facing surfel at (x, y, z), scale s: for the identity pose,
    T = K @ [[s,0,x],[0,s,y],[0,0,z]]."""
    K = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1.0]])
    S = np.array([[s, 0, x], [0, s, y], [0, 0, z]])
    T = K @ S
    Tu, Tv, Tw = T[0], T[1], T[2]
    k = px * Tw - Tu
    l = py * Tw - Tv
    p = np.cross(k, l)
    su, sv = p[0] / p[2], p[1] / p[2]
    rho3d = su * su + sv * sv
    cx2d = FX * x / z + W / 2       # low-pass centre = projected mean
    cy2d = FY * y / z + H / 2
    rho2d = 2.0 * ((cx2d - px) ** 2 + (cy2d - py) ** 2)
    rho = min(rho3d, rho2d)
    depth = (su * Tw[0] + sv * Tw[1] + Tw[2]) if rho3d <= rho2d else z
    alpha = min(0.99, opacity * np.exp(-0.5 * rho))
    if p[2] == 0 or depth < 0.2 or alpha < 1.0 / 255.0:
        alpha = 0.0
    return alpha, depth


@pytest.mark.parametrize("route", ROUTES)
def test_single_splat_alpha(route):
    img, _, _ = _render(route, *_splat(), [[1.0, 0.5, 0.25]])
    for (iy, ix) in [(16, 16), (14, 18), (20, 12)]:
        a, _ = _hand_alpha(ix + 0.5, iy + 0.5, 0.0, 0.0, 2.0, 0.5, 0.8)
        np.testing.assert_allclose(img[iy, ix], a * np.array(
            [1.0, 0.5, 0.25]), rtol=2e-5, atol=1e-6,
            err_msg=f"pixel {(iy, ix)}")


@pytest.mark.parametrize("route", ROUTES)
def test_lowpass_branch(route):
    """A sub-pixel splat: rho2d (the 1/sqrt(2) screen filter) governs the
    footprint, a multi-pixel response despite s ~ 0."""
    img, _, _ = _render(route, *_splat(s=1e-3, opacity=0.9), np.ones((1, 3)))
    a_c, _ = _hand_alpha(16.5, 16.5, 0, 0, 2.0, 1e-3, 0.9)
    np.testing.assert_allclose(img[16, 16, 0], a_c, rtol=1e-4)
    a_n, _ = _hand_alpha(17.5, 16.5, 0, 0, 2.0, 1e-3, 0.9)
    assert a_n > 0.05                        # neighbour via low-pass only
    np.testing.assert_allclose(img[16, 17, 0], a_n, rtol=1e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_alpha_cutoff_and_clip(route):
    # clip: opacity 1.0 => alpha capped at 0.99 at the centre
    means, scales, quats, _ = _splat(opacity=1.0)
    img, _, _ = _render(route, means, scales, quats, [1.0], np.ones((1, 3)))
    np.testing.assert_allclose(float(img[16, 16, 0]), 0.99, rtol=1e-5)
    # cutoff: alpha below 1/255 contributes exactly nothing
    img2, _, _ = _render(route, means, scales, quats, [1.0 / 300.0],
                         np.ones((1, 3)))
    assert float(np.abs(img2).max()) == 0.0


@pytest.mark.parametrize("route", ROUTES)
def test_near_plane_rule(route):
    """Intersection depth below NEAR_PLANE (0.2) is excluded even when the
    centre is in front of the plane."""
    img, _, _ = _render(route, *_splat(z=0.15), np.ones((1, 3)))
    assert float(np.abs(img).max()) == 0.0
    img, _, _ = _render(route, *_splat(z=0.25), np.ones((1, 3)))
    assert float(img[16, 16, 0]) > 0.5


@pytest.mark.parametrize("route", ROUTES)
def test_termination_drops_crossing_gaussian(route):
    """Stacked splats with alpha ~= 0.8: T after k splats = 0.2^k crosses
    1e-4 at the 6th, which is dropped with everything after it
    (forward.cu:400-405), so exactly 5 blend."""
    n = 8
    img, allmap, _ = _render(route, *_stack([2.0 + 0.1 * i for i in
                                             range(n)], 5.0, 0.8),
                             np.ones((n, 3)))
    a = 0.8
    expect = sum(a * (1 - a) ** i for i in range(5))   # 1 - 0.2^5
    np.testing.assert_allclose(float(img[16, 16, 0]), expect, rtol=2e-4)
    np.testing.assert_allclose(float(allmap[16, 16, 1]),
                               1 - (1 - a) ** 5, rtol=2e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_median_depth_rule(route):
    """Median depth = depth of the LAST blended splat with pre-blend
    T > 0.5 (forward.cu:418-427)."""
    _, allmap, _ = _render(route, *_stack([2.0, 3.0, 4.0], 5.0, 0.45),
                           np.ones((3, 3)))
    # pre-blend T: 1.0 (depth 2), 0.55 (depth 3, overwrites), 0.3025 (no)
    np.testing.assert_allclose(float(allmap[16, 16, 5]), 3.0, rtol=1e-4)
    # median weight = w of the writer: alpha * T_before = 0.45 * 0.55
    np.testing.assert_allclose(float(allmap[16, 16, 7]), 0.45 * 0.55,
                               rtol=1e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_allmap_channels(route):
    """The expected-depth channel stores sum(w*z) (alpha-weighted)."""
    _, allmap, _ = _render(route, *_splat(z=2.0, s=5.0, opacity=0.6),
                           np.ones((1, 3)))
    np.testing.assert_allclose(float(allmap[16, 16, 0]), 0.6 * 2.0,
                               rtol=1e-4)
    np.testing.assert_allclose(float(allmap[16, 16, 1]), 0.6, rtol=1e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_normal_flip(route):
    """DUAL_VISIABLE: the normal is flipped to face the camera whatever
    the stored orientation (forward.cu:104-109)."""
    for quat in ([1.0, 0, 0, 0], [0.0, 1.0, 0, 0]):   # +z and -z normals
        _, allmap, _ = _render(route, [[0.0, 0.0, 2.0]], [[5.0, 5.0]],
                               [quat], [0.7], np.ones((1, 3)))
        assert float(allmap[16, 16, 4]) < 0


@pytest.mark.parametrize("route", ROUTES)
def test_background_composite(route):
    bg = np.array([0.2, 0.4, 0.8], np.float32)
    img, _, _ = _render(route, *_splat(s=5.0, opacity=0.6), np.zeros((1, 3)),
                        bg=bg)
    # C = w*colour + T_final*bg = 0 + 0.4*bg
    np.testing.assert_allclose(img[16, 16], 0.4 * bg, rtol=1e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_distortion_accumulator(route):
    """Two splats: distortion = sum_i w_i (m_i^2 A_i + D2_i - 2 m_i D1_i)
    with the pre-blend accumulators (forward.cu:408-428)."""
    _, allmap, _ = _render(route, *_stack([2.0, 4.0], 5.0, 0.5),
                           np.ones((2, 3)))
    far, near = 100.0, 0.2
    m = lambda z: (far * z - far * near) / ((far - near) * z)
    m1, m2 = m(2.0), m(4.0)
    w1 = 0.5
    w2 = 0.5 * (1 - 0.5)
    # splat 1: A = 0, so err1 = 0; splat 2: A = 0.5, D1 = w1 m1,
    # D2 = w1 m1^2
    err2 = m2 * m2 * 0.5 + w1 * m1 * m1 - 2 * m2 * w1 * m1
    np.testing.assert_allclose(float(allmap[16, 16, 6]), w2 * err2,
                               rtol=5e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_radius_and_rect(route):
    """radius = ceil(3 * max(extent, 0.7071)); the extent of an
    axis-aligned surfel is s * f / z pixels."""
    _, _, radii = _render(route, *_splat(z=2.0, s=0.5), np.ones((1, 3)))
    expect = np.ceil(3 * max(0.5 * FX / 2.0, 0.7071067811865476))
    assert int(radii[0]) == int(expect)
