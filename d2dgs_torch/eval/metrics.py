"""Image quality metrics (counterpart of d2dgs_tpu/eval/metrics.py, the
reference's render.py:63-89 and metrics.py:74-81): PSNR, SSIM, MS-SSIM
and LPIPS.

PSNR and SSIM come from ops/ssim.py (shared with the training loss);
MS-SSIM is the 5-scale Wang et al. product with pytorch_msssim's
weights.  LPIPS needs trained VGG16 weights, which the repo does not
ship: ``Lpips`` loads an npz the user provides (``lpips_vgg``), and
``Lpips.random`` is the documented substitute (``lpips_rand``), the same
random VGG16 as the JAX package's, drawn from ``np.random.RandomState``.
The metric's convolutions run in float32 (cuDNN's TF32 off), so
``lpips_rand`` means the same on the card as on the CPU.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.ssim import _filter2d, _float32_conv, _window1d, psnr, ssim

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pool over [H,W,C] (edge-padded to even first)."""
    H, W, C = img.shape
    if H % 2:
        img = torch.cat([img, img[-1:]], dim=0)
    if W % 2:
        img = torch.cat([img, img[:, -1:]], dim=1)
    H2, W2 = img.shape[0] // 2, img.shape[1] // 2
    return img.reshape(H2, 2, W2, 2, C).mean(dim=(1, 3))


def _ssim_parts(a, b, window_size=11):
    """Returns (mean contrast-structure term, mean luminance*cs term)."""
    win = torch.as_tensor(_window1d(window_size), device=a.device)
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = _filter2d(a, win), _filter2d(b, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2d(a * a, win) - mu1_sq
    s2 = _filter2d(b * b, win) - mu2_sq
    s12 = _filter2d(a * b, win) - mu12
    cs = (2 * s12 + C2) / (s1 + s2 + C2)
    lum = (2 * mu12 + C1) / (mu1_sq + mu2_sq + C1)
    return torch.mean(cs), torch.mean(lum * cs)


def msssim(a: torch.Tensor, b: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM over [H,W,C] images in [0,1]."""
    vals = []
    for i in range(levels):
        cs, ss = _ssim_parts(a, b)
        vals.append(ss if i == levels - 1 else cs)
        if i < levels - 1:
            a, b = _avg_pool2(a), _avg_pool2(b)
    vals = torch.stack(vals)
    w = torch.tensor(_MSSSIM_WEIGHTS[:levels], dtype=torch.float32,
                     device=vals.device)
    return torch.prod(torch.clamp_min(vals, 1e-6) ** w)


# ----------------------------------------------------------------------
# LPIPS (VGG16 backbone)
# ----------------------------------------------------------------------

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_TAP_LAYERS = (1, 3, 6, 9, 12)  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_SHIFT = np.array([-.030, -.088, -.188], np.float32)
_SCALE = np.array([.458, .448, .450], np.float32)


class Lpips:
    """LPIPS-VGG.  Weights npz layout: conv{i}_w [O,I,3,3], conv{i}_b [O]
    for the 13 VGG convs, lin{j}_w [C] for the 5 calibration heads.  The
    weights move to the device of the images on first use."""

    def __init__(self, weights_path: str):
        with np.load(weights_path) as z:
            self._host = ([(z[f"conv{i}_w"], z[f"conv{i}_b"])
                           for i in range(13)],
                          [z[f"lin{j}_w"] for j in range(5)])
        self._dev: dict = {}

    @classmethod
    def random(cls, seed: int = 0) -> "Lpips":
        """He-initialized VGG16 features from ``RandomState(seed)`` and
        uniform calibration heads, as the JAX package's ``Lpips.random``
        (reported as ``lpips_rand``, never as ``lpips_vgg``)."""
        self = cls.__new__(cls)
        rng = np.random.RandomState(seed)
        convs, cin = [], 3
        for c in _VGG_CFG:
            if c == "M":
                continue
            w = rng.normal(0, np.sqrt(2.0 / (cin * 9)),
                           (c, cin, 3, 3)).astype(np.float32)
            convs.append((w, np.zeros((c,), np.float32)))
            cin = c
        lins = [np.full((t,), 1.0 / t, np.float32)
                for t in (64, 128, 256, 512, 512)]
        self._host = (convs, lins)
        self._dev = {}
        return self

    def _weights(self, device):
        key = str(device)
        if key not in self._dev:
            t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                          device=device)
            convs, lins = self._host
            self._dev[key] = ([(t(w), t(b)) for w, b in convs],
                              [t(w) for w in lins])
        return self._dev[key]

    def _features(self, x, convs):
        # x [H,W,3] in [0,1] -> scaled, NCHW
        shift = torch.as_tensor(_SHIFT, device=x.device)
        scale = torch.as_tensor(_SCALE, device=x.device)
        h = ((x * 2.0 - 1.0 - shift) / scale).permute(2, 0, 1)[None]
        feats, conv_i = [], 0
        for c in _VGG_CFG:
            if c == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            w, b = convs[conv_i]
            h = torch.relu(F.conv2d(h, w, padding=1) + b[None, :, None, None])
            if conv_i in _TAP_LAYERS:
                feats.append(h)
            conv_i += 1
        return feats

    @torch.no_grad()
    def __call__(self, a, b):
        convs, lins = self._weights(a.device)
        with _float32_conv():
            fa, fb = self._features(a, convs), self._features(b, convs)
        total = 0.0
        for x, y, w in zip(fa, fb, lins):
            xn = x / torch.sqrt(torch.sum(x * x, 1, keepdim=True) + 1e-10)
            yn = y / torch.sqrt(torch.sum(y * y, 1, keepdim=True) + 1e-10)
            d = (xn - yn) ** 2
            total = total + torch.mean(torch.sum(
                d * w[None, :, None, None], dim=1))
        return total


_LPIPS_CACHE: dict = {}


def get_lpips(weights_path: str | None = None):
    """An Lpips callable, or None if no weights are available."""
    path = weights_path or os.environ.get("D2DGS_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    if path not in _LPIPS_CACHE:
        _LPIPS_CACHE[path] = Lpips(path)
    return _LPIPS_CACHE[path]


def get_lpips_rand():
    if "rand" not in _LPIPS_CACHE:
        _LPIPS_CACHE["rand"] = Lpips.random()
    return _LPIPS_CACHE["rand"]


@torch.no_grad()
def evaluate_image_metrics(pred, gt, lpips_weights: str | None = None,
                           lpips_rand: bool = True) -> dict:
    """-> dict of floats.  ``lpips_vgg`` only with provided trained
    weights; ``lpips_rand`` is the always-available substitute.  ``pred``
    and ``gt``: [H,W,3] tensors (``gt`` may be a numpy array)."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    gt = torch.as_tensor(gt, dtype=torch.float32, device=pred.device)
    out = {
        "psnr": float(psnr(pred, gt)),
        "ssim": float(ssim(pred, gt)),
        "ms_ssim": float(msssim(pred, gt)),
    }
    lp = get_lpips(lpips_weights)
    if lp is not None:
        out["lpips_vgg"] = float(lp(pred, gt))
    if lpips_rand:
        out["lpips_rand"] = float(get_lpips_rand()(pred, gt))
    return out
