"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports torch, numpy and d2dgs_torch only, so it also
runs on a GPU machine without JAX; there, skip the suite's conftest (it
configures JAX) and the xdist options of pytest.ini:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""

Every test skips where torch.cuda.is_available() is False."""
import numpy as np
import pytest
import torch

from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.ops.binning import bin_gaussians
from d2dgs_torch.ops.cuda.blend import blend_fwd
from d2dgs_torch.ops.dense_raster import rasterize_dense
from d2dgs_torch.ops.projection import preprocess, tile_grid
from d2dgs_torch.ops.tiled_raster import (ROW_DONE, ROW_N_EVAL, ROW_T,
                                          blend_tiles_plain, pack_features,
                                          rasterize_tiled)

IMG = dict(rtol=1e-5, atol=1e-5)      # T, done and colour rows; the image
AUX = dict(rtol=1e-4, atol=1e-5)      # the other state rows; the allmap


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _scene(opaque, dev):
    """48x64 view of 160 random splats (the shapes of
    tests/test_pallas_blend.py), optionally all at opacity 0.999."""
    n = 160
    rs = np.random.RandomState(0)
    means = rs.normal(size=(n, 3)) * 0.5
    scales = np.exp(rs.normal(size=(n, 2)) * 0.3) * 0.08
    quats = rs.normal(size=(n, 4)) + np.array([1.0, 0, 0, 0])
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = 1.0 / (1.0 + np.exp(-(rs.normal(size=n) + 1.0)))
    if opaque:
        opac = np.full(n, 0.999)    # saturates T: early termination
    colors = rs.uniform(size=(n, 3))
    cam = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=48, W=64, device=dev)
    return cam, [torch.as_tensor(np.asarray(a, np.float32), device=dev)
                 for a in (means, scales, quats, opac, colors)]


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
def test_blend_wrapper_refuses_bad_inputs(cuda):
    cam, arrs = _scene(False, cuda)
    fs, rank, start, count, gx = _kernel_args(cam, *arrs)
    with pytest.raises(NotImplementedError, match="backward"):
        blend_fwd(fs.clone().requires_grad_(), rank, start, count, gx)
    with pytest.raises(TypeError, match="pair_rank"):
        blend_fwd(fs, rank.long(), start, count, gx)
    with pytest.raises(ValueError, match="tile_count"):
        blend_fwd(fs, rank, start, count.cpu(), gx)
    with pytest.raises(ValueError, match="contiguous"):
        blend_fwd(fs.t().contiguous().t(), rank, start, count, gx)
