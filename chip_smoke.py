"""Smoke test of the PyTorch/CUDA port (``d2dgs_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit):
  1. require CUDA, print the card's name and power limit, build the
     blend kernel from d2dgs_torch/csrc with nvcc;
  2. hold the blend kernel against its plain PyTorch version on the card:
     a 48x64 scene of 160 splats, the same scene all opaque (early
     termination), and the full-width scene of phase 3; check the tiled
     CUDA render of the small scene against the dense oracle;
  3. the served path at full width: 83,252 Gaussians from
     CONVERGENCE_r05_dist.npz at capacity 100,000, SH degree 3, 1024
     control nodes with the 8x256 deform MLP and its timenet, and four
     800x800 requests at t = 0, 0.25, 0.5, 0.75, each a node warp plus a
     render; checks finite outputs, coverage and one kernel launch per
     request, then times the kernel, its plain version and each render
     with CUDA events.
The line before the last is the JSON record of the kernels, then the
card's name and power limit; the last line is the device JSON.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# float32 operations per (pair, pixel) in csrc/blend_fwd.cu: the response
# of every evaluated pair (ray-splat intersection, low-pass, exp, masks)
# and the compositing of every blended pair (T, colour, normal, depth,
# distortion, median).
OPS_EVAL = 46
OPS_BLEND = 39

# kernel-vs-plain tolerances per state row (rtol, atol): colour and alpha
# as the image, the auxiliary rows as the allmap in the JAX package's
# kernel tests (tests/test_pallas_blend.py)
TIGHT = (1e-5, 1e-5)
AUX = (1e-4, 1e-5)
MAX_FLIP_SHARE = 1e-4     # pixels whose termination/median branch flips


def log(msg):
    print(msg, flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of fn() in ms from CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def small_scene(opaque: bool):
    """48x64 view of 160 random splats (the shapes of the JAX package's
    blend-kernel tests), optionally all at opacity 0.999."""
    n = 160
    rs = np.random.RandomState(0)
    means = rs.normal(size=(n, 3)) * 0.5
    scales = np.exp(rs.normal(size=(n, 2)) * 0.3) * 0.08
    quats = rs.normal(size=(n, 4)) + np.array([1.0, 0, 0, 0])
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = 1.0 / (1.0 + np.exp(-(rs.normal(size=n) + 1.0)))
    if opaque:
        opac = np.full(n, 0.999)
    colors = rs.uniform(size=(n, 3))
    f32 = lambda a: np.asarray(a, np.float32)
    return tuple(map(f32, (means, scales, quats, opac, colors)))


def splat_inputs(means3d, scales, quats, opacity, colors, valid_mask, cam,
                 cfg):
    """The blend kernel's inputs for one view, as render() builds them."""
    from d2dgs_torch.ops.binning import bin_gaussians
    from d2dgs_torch.ops.projection import preprocess, tile_grid
    from d2dgs_torch.ops.tiled_raster import pack_features
    gx, gy = tile_grid(cam.H, cam.W)
    prep = preprocess(means3d, scales, quats, cam)
    valid = prep.valid & valid_mask
    prep = prep._replace(valid=valid)
    opac = torch.where(valid, opacity, 0.0)
    binning = bin_gaussians(prep, gx, gy, cfg, opacity=opac)
    feats = pack_features(prep.T, prep.center, prep.normal, colors, opac)
    return feats[binning.order.long()].contiguous(), binning, gx


def compare_states(sk: torch.Tensor, sp: torch.Tensor) -> dict:
    """Kernel state rows vs the plain version's.  A pixel 'flips' when
    its termination (done row) or its median-depth choice (median rows)
    differs; every other pixel must agree within the row tolerances."""
    from d2dgs_torch.ops.tiled_raster import (ROW_COLOR, ROW_D1, ROW_D2,
                                              ROW_DEPTH, ROW_DISTORTION,
                                              ROW_DONE, ROW_MED_D, ROW_MED_W,
                                              ROW_N_BLEND, ROW_N_EVAL,
                                              ROW_NORMAL, ROW_T)
    tol = {ROW_T: TIGHT, ROW_D1: AUX, ROW_D2: AUX, ROW_DEPTH: AUX,
           ROW_DISTORTION: AUX, ROW_MED_D: AUX, ROW_MED_W: AUX}
    for sl, t in ((ROW_COLOR, TIGHT), (ROW_NORMAL, AUX)):
        tol.update({r: t for r in range(sl.start, sl.stop)})

    def close(r):
        rtol, atol = tol[r]
        return (sk[:, r] - sp[:, r]).abs() <= atol + rtol * sp[:, r].abs()

    flip = (sk[:, ROW_DONE] != sp[:, ROW_DONE]) | ~close(ROW_MED_D) \
        | ~close(ROW_MED_W)
    keep = ~flip
    row_err = {r: float((sk[:, r] - sp[:, r]).abs()[keep].max())
               if bool(keep.any()) else 0.0 for r in sorted(tol)}
    bad = torch.zeros_like(flip)
    for r in tol:
        bad |= ~close(r)
    for r in (ROW_N_EVAL, ROW_N_BLEND):
        bad |= sk[:, r] != sp[:, r]
    bad &= keep
    n_pix = flip.numel()
    return {"row_max_abs_err": row_err, "flipped": int(flip.sum()),
            "pixels": n_pix, "bad_outside_flips": int(bad.sum()),
            "max_abs_err": max(row_err.values())}


def check_kernel(label, feats_sorted, binning, gx, chunk):
    from d2dgs_torch.ops.cuda.blend import blend_fwd
    from d2dgs_torch.ops.tiled_raster import blend_tiles_plain
    args = (feats_sorted, binning.pair_rank, binning.tile_start,
            binning.tile_count, gx)
    sk = blend_fwd(*args)
    torch.cuda.synchronize()
    sp = blend_tiles_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    res = compare_states(sk, sp)
    log(f"[phase 2] {label}: pairs {int(binning.num_pairs)}, flipped "
        f"pixels {res['flipped']}/{res['pixels']}, outside-tolerance "
        f"pixels beyond flips {res['bad_outside_flips']}, max |err| per row "
        + json.dumps({str(k): v for k, v in res['row_max_abs_err'].items()}))
    if res["bad_outside_flips"] or \
            res["flipped"] > MAX_FLIP_SHARE * res["pixels"]:
        raise AssertionError(f"blend kernel disagrees with its plain "
                             f"version on {label}: {res}")
    return sk, res


def full_scene(dev):
    """83,252 converged Gaussians at capacity 100,000 and 1024 nodes."""
    from d2dgs_torch.models.deform import DeformConfig
    from d2dgs_torch.models.deform_mlp import MLPConfig
    from d2dgs_torch.models.gaussians import create_from_pcd
    from d2dgs_torch.models.nodes import (NodeConfig, init_node_params,
                                          init_nodes_from_pcl)
    with np.load(ROOT / "CONVERGENCE_r05_dist.npz") as z:
        xyz, scaling, opacity = z["xyz"], z["scaling"], z["opacity"]
    n = xyz.shape[0]
    rgb = np.random.RandomState(1).uniform(size=(n, 3)).astype(np.float32)
    rest = 0.05 * np.random.RandomState(2).normal(size=(n, 15, 3))
    gauss = create_from_pcd(xyz, rgb, capacity=100_000, sh_degree=3,
                            fea_dim=8, device=dev)
    with torch.no_grad():
        gauss.scaling[:n] = torch.as_tensor(scaling, device=dev)
        gauss.opacity[:n] = torch.as_tensor(opacity, device=dev)
        gauss.features_rest[:n] = torch.as_tensor(rest, dtype=torch.float32,
                                                  device=dev)
    gauss.active_sh_degree = 3
    # the JAX package's TrainConfig defaults: 1024 nodes, K=3, hyper_dim 8,
    # blender timenet, local frames
    node_cfg = NodeConfig(node_num=1024, K=3, hyper_dim=8,
                          mlp=MLPConfig(is_blender=True, local_frame=True))
    gen = torch.Generator().manual_seed(0)
    nodes = init_node_params(node_cfg, gen, device=dev)
    init_nodes_from_pcl(nodes, node_cfg, torch.as_tensor(xyz), generator=gen)
    return gauss, nodes, DeformConfig(deform_type="node", node=node_cfg)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.models.deform import deform_gaussians
    from d2dgs_torch.models.gaussians import apply_deform
    from d2dgs_torch.ops.binning import bin_gaussians
    from d2dgs_torch.ops.cuda import build
    from d2dgs_torch.ops.cuda.blend import SOURCE, blend_fwd
    from d2dgs_torch.ops.dense_raster import rasterize_dense
    from d2dgs_torch.ops.projection import preprocess, tile_grid
    from d2dgs_torch.ops.tiled_raster import (ROW_N_BLEND, ROW_N_EVAL,
                                              blend_tiles_plain,
                                              pack_features, rasterize_tiled)
    from d2dgs_torch.render.renderer import render
    from d2dgs_torch.utils.sh import sh_to_rgb

    t_start = time.time()
    dev = torch.device("cuda")
    card = gpu_name_power()
    log(f"[phase 1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.time()
    lib, report = build.build(SOURCE)
    log(f"[phase 1] built {lib.relative_to(ROOT)} in {time.time() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[phase 1] ptxas: {line.strip()}")
    cfg = RasterConfig()

    # ---- phase 2: kernel vs plain on small scenes, tiled vs dense ----
    H, W = 48, 64
    cam_s = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=H, W=W, device=dev)
    for opaque in (False, True):
        arrs = [torch.as_tensor(a, device=dev) for a in small_scene(opaque)]
        means, scales, quats, opac, colors = arrs
        alive = torch.ones(means.shape[0], dtype=torch.bool, device=dev)
        fs, binning, gx = splat_inputs(means, scales, quats, opac, colors,
                                       alive, cam_s, cfg)
        label = "48x64 opaque" if opaque else "48x64"
        check_kernel(label, fs, binning, gx, cfg.chunk)
        bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
        ct, at, *_ = rasterize_tiled(means, scales, quats, opac, colors,
                                     cam_s, bg, cfg=cfg)
        cd, ad, *_ = rasterize_dense(means, scales, quats, opac, colors,
                                     cam_s, bg)
        torch.testing.assert_close(ct, cd, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(at, ad, rtol=1e-4, atol=1e-4)
        log(f"[phase 2] {label}: CUDA tiled render matches the dense "
            f"oracle (max |d image| {float((ct - cd).abs().max()):.3g})")

    t0 = time.time()
    gauss, nodes, deform_cfg = full_scene(dev)
    torch.cuda.synchronize()
    log(f"[phase 3] scene: {int(gauss.num_alive)} alive of "
        f"{gauss.capacity}, {int(nodes.num_alive)} nodes, built in "
        f"{time.time() - t0:.1f} s")
    bg = torch.zeros(3, device=dev)
    times = (0.0, 0.25, 0.5, 0.75)
    cams = [orbit_camera(0.3, 0.25, 4.0, fov=0.69, H=800, W=800, time=t,
                         device=dev) for t in times]

    def warp(cam):
        return deform_gaussians(nodes, deform_cfg, gauss.xyz, cam.time,
                                feature=gauss.feature,
                                motion_mask=gauss.motion_mask)

    def serve(cam):
        """One request: the node warp, then the render."""
        d = warp(cam)
        return render(cam, gauss, bg, d_xyz=d["d_xyz"],
                      d_rotation=d["d_rotation"], d_scaling=d["d_scaling"],
                      cfg=cfg)

    def shade(cam, d):
        """apply_deform and the SH colours, as render() does."""
        means, scales, quats, opac, sh = apply_deform(
            gauss, d["d_xyz"], d["d_rotation"], d["d_scaling"])
        dirs = means - cam.cam_center[None, :]
        dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True)
                                 + 1e-20)
        return means, scales, quats, opac, sh_to_rgb(
            gauss.active_sh_degree, sh, dirs)

    def view_inputs(cam):
        return splat_inputs(*shade(cam, warp(cam)), gauss.alive, cam, cfg)

    def stage_ms(cam):
        """CUDA-event time of each stage of one request, run separately."""
        d = warp(cam)
        sh = shade(cam, d)
        means, scales, quats, opac, colors = sh
        gx, gy = tile_grid(cam.H, cam.W)

        def prep_fn():
            prep = preprocess(means, scales, quats, cam)
            return prep._replace(valid=prep.valid & gauss.alive)
        prep = prep_fn()
        op = torch.where(prep.valid, opac, 0.0)
        b = bin_gaussians(prep, gx, gy, cfg, opacity=op)
        feats = lambda: pack_features(prep.T, prep.center, prep.normal,
                                      colors, op)[b.order.long()].contiguous()
        fs = feats()
        return {
            "warp": cuda_ms(lambda: warp(cam), reps=5),
            "shade": cuda_ms(lambda: shade(cam, d), reps=5),
            "preprocess": cuda_ms(prep_fn, reps=5),
            "binning": cuda_ms(lambda: bin_gaussians(prep, gx, gy, cfg,
                                                     opacity=op), reps=5),
            "features": cuda_ms(feats, reps=5),
            "blend_kernel": cuda_ms(lambda: blend_fwd(
                fs, b.pair_rank, b.tile_start, b.tile_count, gx), reps=5)}

    with torch.no_grad():
        inputs = [view_inputs(c) for c in cams]
        fs0, bin0, gx0 = inputs[0]
        state0, res0 = check_kernel("800x800 t=0", fs0, bin0, gx0, cfg.chunk)

        # ---- phase 3: the served path, counted ----
        blend_fwd.launches = 0
        outs = []
        for i, cam in enumerate(cams):
            out = serve(cam)
            torch.cuda.synchronize()
            if blend_fwd.launches != i + 1:
                raise AssertionError(f"request {i}: blend kernel launches "
                                     f"{blend_fwd.launches}, expected {i + 1}")
            outs.append(out)
        launches = blend_fwd.launches
        for t, out in zip(times, outs):
            if out.image.shape != (800, 800, 3) or \
                    out.depth.shape != (800, 800, 1):
                raise AssertionError(f"t={t}: shapes {out.image.shape} "
                                     f"{out.depth.shape}")
            for name in ("image", "depth", "alpha", "rend_normal",
                         "rend_dist", "surf_normal"):
                if not bool(torch.isfinite(getattr(out, name)).all()):
                    raise AssertionError(f"t={t}: non-finite {name}")
            cover = float((out.alpha > 0).float().mean())
            if cover <= 0.0:
                raise AssertionError(f"t={t}: empty render")
            if int(out.overflow) or int(out.clamped):
                raise AssertionError(f"t={t}: overflow/clamped non-zero")
            log(f"[phase 3] t={t}: num_pairs {int(out.num_pairs)}, coverage "
                f"{cover:.4f}, mean rgb {float(out.image.mean()):.4f}")

        # ---- timing (CUDA events, one warm-up each) ----
        kernel_ms, render_ms = [], []
        for t, cam, (fs, binning, gx) in zip(times, cams, inputs):
            args = (fs, binning.pair_rank, binning.tile_start,
                    binning.tile_count, gx)
            kernel_ms.append(cuda_ms(lambda: blend_fwd(*args), reps=20))
            render_ms.append(cuda_ms(lambda: serve(cam), reps=5))
            log(f"[phase 3] t={t}: num_pairs {int(binning.num_pairs)}, max "
                f"tile count {int(binning.tile_count.max())}, kernel "
                f"{kernel_ms[-1]:.4f} ms, render {render_ms[-1]:.3f} ms "
                f"({card})")
        stages = stage_ms(cams[0])
        log(f"[phase 3] t=0 stages (ms, each timed alone): "
            + json.dumps(stages) + f"; sum {sum(stages.values()):.3f} of "
            f"render {render_ms[0]:.3f}")
        args0 = (fs0, bin0.pair_rank, bin0.tile_start, bin0.tile_count, gx0)
        plain_ms = cuda_ms(lambda: blend_tiles_plain(*args0, chunk=cfg.chunk),
                           reps=3)

    # bound of the t=0 launch: bytes in and out once, and the float32
    # operations of the pairs each pixel evaluated and blended
    n_eval = float(state0[:, ROW_N_EVAL].sum())
    n_blend = float(state0[:, ROW_N_BLEND].sum())
    ops = OPS_EVAL * n_eval + OPS_BLEND * n_blend
    nbytes = (fs0.numel() * 4 + bin0.pair_rank.numel() * 4
              + 2 * bin0.tile_start.numel() * 4
              + state0.numel() * 4)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    log(f"[phase 3] t=0 bound: {n_eval:.0f} pair-pixel evaluations, "
        f"{n_blend:.0f} blends, {ops:.4g} float32 ops -> {t_ops:.4f} ms; "
        f"{nbytes} bytes -> {t_bytes:.4f} ms; plain version {plain_ms:.3f} "
        f"ms; mean render {np.mean(render_ms):.3f} ms")
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "blend_fwd", "route": "cuda",
        "source": "d2dgs_torch/csrc/blend_fwd.cu",
        "replaces": "d2dgs_tpu/ops/pallas/blend_tpu.py:664",
        "launches": launches, "max_abs_err": res0["max_abs_err"],
        "flipped_pixels": res0["flipped"], "ms": kernel_ms[0],
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "render_ms": render_ms, "stages_ms": stages}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
