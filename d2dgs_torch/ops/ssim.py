"""Image losses (counterpart of d2dgs_tpu/ops/ssim.py, the reference's
utils/loss_utils.py:33-76): window SSIM with an 11x11 Gaussian window of
sigma 1.5, zero "same" padding and the mean over the image; PSNR; L1.

The window is separable, so the blur is two depthwise 1-D convolutions.
cuDNN runs float32 convolutions in TF32 by default, which keeps about
three decimal digits; the blur turns that off around its own calls.  The
blur with a symmetric window and zero padding is its own adjoint, so its
backward is the same two convolutions, run under the same setting.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import trace


@functools.lru_cache()
def _window1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@contextlib.contextmanager
def _float32_conv():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _blur_nchw(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    k = win.shape[0]
    wv = win.view(1, 1, k, 1).expand(c, 1, k, 1)
    wh = win.view(1, 1, 1, k).expand(c, 1, 1, k)
    with _float32_conv():
        x = F.conv2d(x, wv, padding=(k // 2, 0), groups=c)
        return F.conv2d(x, wh, padding=(0, k // 2), groups=c)


class _Blur(torch.autograd.Function):
    """Separable Gaussian blur of [1, C, H, W]; self-adjoint."""

    @staticmethod
    def forward(ctx, x, win):
        ctx.save_for_backward(win)
        return _blur_nchw(x, win)

    @staticmethod
    def backward(ctx, g):
        win, = ctx.saved_tensors
        return _blur_nchw(g.contiguous(), win), None


def _filter2d(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> the window-blurred [H, W, C]."""
    x = img.permute(2, 0, 1)[None].contiguous()
    return _Blur.apply(x, win)[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """img: [H,W,C] in [0,1]. Returns mean SSIM (size_average=True)."""
    trace.count("host.reads", 1)  # a copy from host memory
    win = torch.as_tensor(_window1d(window_size), device=img1.device)
    mu1 = _filter2d(img1, win)
    mu2 = _filter2d(img2, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2d(img1 * img1, win) - mu1_sq
    s2 = _filter2d(img2 * img2, win) - mu2_sq
    s12 = _filter2d(img1 * img2, win) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(m)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1 - img2) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))
