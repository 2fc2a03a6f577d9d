"""Command-line interface (counterpart of d2dgs_tpu/cli.py, the reference's
arguments/__init__.py flag system and the train_gui.py / render.py /
render_mesh.py entry points): ``python -m d2dgs_torch.cli <cmd>``.

Flags are generated by reflection over the port's frozen config
dataclasses (``TrainConfig``, and ``RasterConfig`` as ``--raster_*``), so
they are the JAX CLI's, less the JAX-only raster caps (``emission_cap``,
``pair_cap``, ``use_pallas``, ``pallas_interpret``), plus ``--device``
(default ``cuda``; ``--device cpu`` runs the plain PyTorch path).  Without
a GPU and without ``--device cpu`` every command exits non-zero.  The
config snapshot is saved as ``cfg_args.json`` in the model dir and merged
back on eval commands (get_combined_args, arguments/__init__.py:161-184),
all but ``--device``: an eval command runs on the card unless its own
command line asks for the CPU.

``main(argv, report)`` fills an optional ``report`` dict with the
command's measurements (train step times taken with a device
synchronisation around each step, each step's L1, the count of steps
with the optical-flow term, ms per test view, the mesh grid and
its fusion and extraction times, with ``mesh --render_meshes`` the
two mesh renders' times, and for ``edit`` each frame's ARAP solve and
frame time with the solved node positions) for callers that time the CLI.

``train`` takes every deform type (``--deform_type node|mlp|hash|
hexplane|static``); on a scene with RAFT flow files
(``raft_neighbouring/``) it adds the optical-flow loss, as the JAX CLI
does.  ``edit`` drags control nodes of a ``node`` model.  ``train
--mesh_shape DxG`` runs the main
stage on a (data x gauss) rank grid (d2dgs_torch/parallel/): under
``torchrun --nproc_per_node D*G`` every rank runs the command (NCCL on
``cuda``, each rank on its ``LOCAL_RANK``'s card; gloo on ``cpu``), and
rank 0 alone prints, writes checkpoints and renders the test views.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

# ----------------------------------------------------------------------
# flag reflection
# ----------------------------------------------------------------------


def add_dataclass_args(parser: argparse.ArgumentParser, cls,
                       prefix: str = "", skip=()) -> None:
    """One --flag per scalar dataclass field; bools become --x / --no-x
    pairs like the reference's shorthand system."""
    group = parser.add_argument_group(cls.__name__)
    for f in dataclasses.fields(cls):
        if f.name in skip or dataclasses.is_dataclass(f.type) \
                or dataclasses.is_dataclass(type(f.default)):
            continue
        name = f"--{prefix}{f.name}"
        if f.type in ("bool", bool):
            group.add_argument(name, dest=prefix + f.name,
                               action=argparse.BooleanOptionalAction,
                               default=f.default)
        else:
            ty = {"int": int, "float": float, "str": str}.get(
                f.type if isinstance(f.type, str) else f.type.__name__,
                str)
            group.add_argument(name, dest=prefix + f.name, type=ty,
                               default=f.default)


def config_from_args(args: argparse.Namespace):
    """Rebuild TrainConfig (with its RasterConfig) from parsed args."""
    from .config import RasterConfig
    from .train.config import TrainConfig
    raster_kw = {f.name: getattr(args, "raster_" + f.name)
                 for f in dataclasses.fields(RasterConfig)
                 if hasattr(args, "raster_" + f.name)}
    train_kw = {f.name: getattr(args, f.name)
                for f in dataclasses.fields(TrainConfig)
                if hasattr(args, f.name)}
    cfg = TrainConfig(**train_kw, raster=RasterConfig(**raster_kw))
    if cfg.deform_type not in ("node", "mlp", "hash", "hexplane", "static"):
        raise SystemExit(f"--deform_type must be one of node|mlp|hash|"
                         f"hexplane|static, got {cfg.deform_type!r}")
    return cfg


def save_cfg_args(model_path: str, args: argparse.Namespace) -> None:
    os.makedirs(model_path, exist_ok=True)
    payload = {k: v for k, v in vars(args).items()
               if isinstance(v, (int, float, str, bool, type(None)))}
    with open(os.path.join(model_path, "cfg_args.json"), "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)


def merge_cfg_args(args: argparse.Namespace, argv=None) -> argparse.Namespace:
    """Saved training flags fill in anything the eval command did not set
    on its own command line (``argv``, by default ``sys.argv``;
    get_combined_args semantics).  ``--device`` is never taken from the
    saved flags: the default stays ``cuda``."""
    path = os.path.join(args.model_path, "cfg_args.json")
    if not os.path.exists(path):
        return args
    with open(path) as fh:
        saved = json.load(fh)
    given = {a.split("=")[0].lstrip("-").replace("-", "_")
             for a in (sys.argv if argv is None else argv)
             if a.startswith("--")}
    for k, v in saved.items():
        if hasattr(args, k) and k not in given \
                and k not in ("model_path", "device"):
            setattr(args, k, v)
    return args


def _base_parser(cmd: str, train_flags: bool) -> argparse.ArgumentParser:
    from .config import RasterConfig
    from .train.config import TrainConfig
    p = argparse.ArgumentParser(prog=f"d2dgs_torch {cmd}")
    p.add_argument("--source_path", "-s", type=str, required=(cmd == "train"))
    p.add_argument("--model_path", "-m", type=str, required=True)
    p.add_argument("--eval", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="hold out the test split (default); --no-eval "
                        "trains on all cameras (reference -eval flag)")
    p.add_argument("--resolution", "-r", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    add_dataclass_args(p, TrainConfig)
    add_dataclass_args(p, RasterConfig, prefix="raster_")
    if train_flags:
        p.add_argument("--test_iterations", type=int, nargs="+",
                       default=[5000, 10000, 20000, 40000, 80000])
        p.add_argument("--save_iterations", type=int, nargs="+",
                       default=[10000, 40000, 80000])
        p.add_argument("--log_every", type=int, default=100)
        p.add_argument("--resume", type=str, default=None)
        p.add_argument("--tensorboard", action="store_true")
        p.add_argument("--profile", type=int, default=0, metavar="N",
                       help="write a torch.profiler trace of N steps "
                            "(starting at step 50) into "
                            "<model_path>/profile")
        p.add_argument("--mesh_shape", type=str, default=None,
                       metavar="DxG",
                       help="run the main stage on a D (data) x G (gauss) "
                            "rank grid: D*G ranks under torchrun "
                            "--nproc_per_node, or 1x1 in one process")
        p.add_argument("--exchange_cap", type=int, default=None,
                       help="records per (source, destination) rank pair "
                            "of the sharded stage's tile exchange "
                            "(default: sized from the scene)")
    return p


def _device(args):
    """The command's device; exits non-zero when CUDA is asked for and
    absent (no quiet CPU run)."""
    from .utils.general import resolve_device
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"d2dgs_torch: {e} (--device cpu)") from e


def _downscale(sample, factor: int):
    if factor <= 1:
        return sample
    from PIL import Image

    cam = sample.camera
    H, W = cam.H // factor, cam.W // factor

    def resize(a):
        if a is None:
            return None
        img = Image.fromarray((np.asarray(a) * 255).astype(np.uint8)
                              .squeeze())
        r = np.asarray(img.resize((W, H), Image.BILINEAR),
                       np.float32) / 255.0
        return r if r.ndim == 3 else r[..., None]

    cam = dataclasses.replace(cam, H=H, W=W, fx=cam.fx / factor,
                              fy=cam.fy / factor)
    return dataclasses.replace(sample, camera=cam,
                               image=resize(sample.image),
                               alpha=resize(sample.alpha))


def _init_points(info, cfg, seed: int):
    """Deterministic init-cloud subsampling to half the static capacity
    (densify headroom).  Shared by cmd_train and _restore, so a restored
    checkpoint's template has the shapes the trainer created."""
    pts, cols = info.init_points, info.init_colors
    budget = max(cfg.gaussian_capacity // 2, 1)
    if pts.shape[0] > budget:
        sel = np.random.RandomState(seed).choice(
            pts.shape[0], budget, replace=False)
        pts, cols = pts[sel], cols[sel]
    return pts, cols


def _load_scene(args, device):
    from .data.dnerf import load_scene
    kw = {} if args.eval else {"eval_split": False}
    info = load_scene(args.source_path, device=device, **kw)
    if args.resolution > 1:
        info.train_cameras = [_downscale(s, args.resolution)
                              for s in info.train_cameras]
        info.test_cameras = [_downscale(s, args.resolution)
                             for s in info.test_cameras]
    return info


def _bg(cfg, device):
    import torch
    return torch.full((3,), 1.0 if cfg.white_background else 0.0,
                      device=device)


# ----------------------------------------------------------------------
# commands
# ----------------------------------------------------------------------

def cmd_train(argv, report=None) -> int:
    from .data.flow import find_flow_dirs
    from .eval.render_sets import render_test_set
    from .io.checkpoint import load_train_state, save_train_state
    from .io.ply import save_gaussian_ply
    from .train.trainer import Trainer

    args = _base_parser("train", train_flags=True).parse_args(argv)
    dev = _device(args)
    primary, own_group = True, False
    if args.mesh_shape:
        import torch.distributed as tdist

        from .parallel.multihost import (is_primary, local_device,
                                         maybe_init_distributed)
        mesh_shape = tuple(int(x) for x in
                           args.mesh_shape.lower().split("x"))
        own_group = not tdist.is_initialized()
        _, world = maybe_init_distributed(dev)
        own_group = own_group and tdist.is_initialized()
        need = mesh_shape[0] * mesh_shape[1]
        if world != need:
            raise SystemExit(
                f"d2dgs_torch: --mesh_shape {args.mesh_shape} needs {need} "
                f"ranks (torchrun --nproc_per_node {need}); this run has "
                f"{world}")
        dev, primary = local_device(dev), is_primary()
    cfg = config_from_args(args)
    if primary:
        save_cfg_args(args.model_path, args)
    info = _load_scene(args, dev)

    bg = np.full(3, 1.0 if cfg.white_background else 0.0, np.float32)
    cams = [s.camera for s in info.train_cameras]
    gts = [s.gt(bg) for s in info.train_cameras]

    writer = None
    if args.tensorboard and primary:
        from tensorboardX import SummaryWriter
        writer = SummaryWriter(args.model_path)

    def log_fn(m):
        if not primary:
            return
        line = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in m.items())
        print(line, flush=True)
        if writer is not None:
            for k, v in m.items():
                if isinstance(v, (int, float)):
                    writer.add_scalar(f"train/{k}", v, m.get("iter", 0))

    pts, cols = _init_points(info, cfg, args.seed)
    # RAFT flow files enable the optical-flow loss when present
    flow_dirs = find_flow_dirs(args.source_path, info.train_cameras)
    has_flow = any(flow_dirs)
    tr = Trainer(cfg, cams, gts, pts, cols,
                 cameras_extent=info.cameras_extent, seed=args.seed,
                 log_fn=log_fn, alphas=[s.alpha for s in info.train_cameras],
                 flow_dirs=flow_dirs if has_flow else None,
                 image_names=[s.image_name for s in info.train_cameras]
                 if has_flow else None,
                 device=dev)
    if args.resume:
        tr.state, tr.iteration, tr.iteration_node = load_train_state(
            args.resume, tr.state)
    if args.mesh_shape:
        tr.enable_sharded_training(mesh_shape, exchange_cap=args.exchange_cap)
        log_fn({"sharded": args.mesh_shape, "exchange_cap": tr.exchange_cap})
        if report is not None:
            report["exchange_cap"] = tr.exchange_cap

    best_psnr, total = -1.0, cfg.iterations + cfg.iterations_node_rendering
    test_iters = set(args.test_iterations)
    save_iters = set(args.save_iterations)
    prof_start, prof = 50, None
    prof_dir = os.path.join(args.model_path, "profile")
    while tr.iteration_node + tr.iteration - 2 < total:
        tick0 = tr.iteration_node + tr.iteration - 2
        if args.profile and tick0 == prof_start and prof is None:
            import torch.profiler as tp
            acts = [tp.ProfilerActivity.CPU] + (
                [tp.ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = tp.profile(activities=acts)
            prof.start()
        if prof is not None and tick0 >= prof_start + args.profile:
            prof.stop()
            os.makedirs(prof_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
            prof = None
            print(f"[profile] trace of {args.profile} steps written to "
                  f"{prof_dir}", flush=True)
        if report is not None:
            _sync(dev)
            t_step = time.perf_counter()
        m = tr.step()
        if report is not None:
            _sync(dev)
            report.setdefault("step_ms", []).append(
                (time.perf_counter() - t_step) * 1e3)
            report["flow_steps"] = (report.get("flow_steps", 0)
                                    + int("lambda_optical" in m))
            if m:
                report.setdefault("loss", []).append(float(m["loss"]))
        it = tr.iteration - 1
        tick = tr.iteration_node + tr.iteration - 2
        if m and tick % args.log_every == 0:
            log_fn(dict({k: float(v) for k, v in m.items()},
                        iter=tr.iteration, iter_node=tr.iteration_node))
        testing = it in test_iters and bool(info.test_cameras)
        if testing or it in save_iters:
            state = tr.full_state()    # sharded: gathered on every rank
        if testing and primary:
            res = render_test_set(
                info.test_cameras, state.gauss, state.nodes,
                cfg.node_cfg, cfg.raster, bg=_bg(cfg, dev),
                save_images=False, deform_cfg=cfg.deform_cfg,
                return_images=5)
            mean = res["mean"]
            print(f"[test @ {it}] " + " ".join(
                f"{k}={v:.4f}" for k, v in mean.items()
                if isinstance(v, float)), flush=True)
            # training-time image reporting (train.py:54-142): render and
            # gt panels into the model dir and TensorBoard
            img_dir = os.path.join(args.model_path, "training_renders",
                                   f"iter_{it}")
            os.makedirs(img_dir, exist_ok=True)
            from PIL import Image
            for vi, (ri, gi) in enumerate(res.get("images", [])):
                Image.fromarray(np.concatenate([ri, gi], axis=1)).save(
                    os.path.join(img_dir, f"view_{vi:02d}.png"))
                if writer is not None:
                    writer.add_image(f"test_view_{vi}/render", ri, it,
                                     dataformats="HWC")
                    if it == min(test_iters):
                        writer.add_image(f"test_view_{vi}/gt", gi, it,
                                         dataformats="HWC")
            if writer is not None:
                for k, v in mean.items():
                    if isinstance(v, float):
                        writer.add_scalar(f"test/{k}", v, it)
            if mean.get("psnr", -1) > best_psnr:  # best-PSNR checkpoint
                best_psnr = mean["psnr"]          # (train_gui.py:395-407)
                save_train_state(
                    os.path.join(args.model_path, "ckpt_best.npz"),
                    state, tr.iteration, tr.iteration_node)
        if it in save_iters and primary:
            d = os.path.join(args.model_path,
                             f"point_cloud/iteration_{it}")
            save_gaussian_ply(os.path.join(d, "point_cloud.ply"),
                              state.gauss)
            save_train_state(os.path.join(args.model_path, "ckpt.npz"),
                             state, tr.iteration, tr.iteration_node)
    state = tr.full_state()
    if primary:
        save_train_state(os.path.join(args.model_path, "ckpt.npz"),
                         state, tr.iteration, tr.iteration_node)
        print(f"training done; best test PSNR {best_psnr:.3f}")
    if own_group:
        tdist.destroy_process_group()
    return 0


def _restore(args, device):
    from .io.checkpoint import load_train_state
    from .train.trainer import init_train_state

    cfg = config_from_args(args)
    info = _load_scene(args, device)
    pts, cols = _init_points(info, cfg, getattr(args, "seed", 0))
    template = init_train_state(cfg, pts, cols, device=device)
    ckpt = os.path.join(args.model_path, args.ckpt)
    if not os.path.exists(ckpt) and args.ckpt == "ckpt_best.npz":
        ckpt = os.path.join(args.model_path, "ckpt.npz")
    state, _, _ = load_train_state(ckpt, template)
    return cfg, info, state


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_render(argv, report=None) -> int:
    p = _base_parser("render", train_flags=False)
    p.add_argument("--ckpt", type=str, default="ckpt_best.npz")
    p.add_argument("--skip_train", action="store_true", default=True)
    p.add_argument("--mode", choices=["test", "spiral", "time"],
                   default="test",
                   help="test = test-set renders + metrics (render.py:33-"
                        "90); spiral = novel-view orbit with t sweeping "
                        "0..1; time = fixed first test view, t sweeping "
                        "(render.py:92-170)")
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--traj_radius", type=float, default=4.0)
    p.add_argument("--traj_elevation", type=float, default=0.3)
    args = merge_cfg_args(p.parse_args(argv), argv)
    dev = _device(args)
    cfg, info, state = _restore(args, dev)

    from .eval.render_sets import render_test_set
    bg = _bg(cfg, dev)
    samples = info.test_cameras or info.train_cameras
    t0 = time.perf_counter()
    if args.mode != "test":
        from .eval.trajectories import (ellipse_path, render_trajectory,
                                        time_sweep_cameras)
        ref_cam = samples[0].camera
        if args.mode == "spiral":
            fov = 2 * np.arctan(ref_cam.W / (2 * float(ref_cam.fx)))
            cams = ellipse_path(args.n_frames, args.traj_radius,
                                args.traj_elevation, fov, ref_cam.H,
                                ref_cam.W, times="sweep", device=dev)
        else:
            cams = time_sweep_cameras(ref_cam, args.n_frames)
        out = os.path.join(args.model_path, args.mode)
        render_trajectory(cams, state.gauss, state.nodes, cfg.node_cfg,
                          cfg.raster, out_dir=out, bg=bg,
                          deform_cfg=cfg.deform_cfg)
        print(f"wrote {args.n_frames} frames to {out} in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        return 0
    out = os.path.join(args.model_path, "test", "renders")
    res = render_test_set(samples, state.gauss, state.nodes, cfg.node_cfg,
                          cfg.raster, out_dir=out, bg=bg,
                          deform_cfg=cfg.deform_cfg)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"rendered {len(samples)} views with metrics and images in "
          f"{ms:.1f} ms ({ms / len(samples):.1f} ms per view)")
    if report is not None:
        report["view_ms"] = ms / len(samples)
    results = {k: v for k, v in res["mean"].items()
               if isinstance(v, float)}
    with open(os.path.join(args.model_path, "results.json"), "w") as fh:
        json.dump(results, fh, indent=2)
    print(json.dumps(results, indent=2))
    return 0


def cmd_mesh(argv, report=None) -> int:
    p = _base_parser("mesh", train_flags=False)
    p.add_argument("--ckpt", type=str, default="ckpt_best.npz")
    p.add_argument("--voxel_size", type=float, default=0.004)
    p.add_argument("--depth_trunc", type=float, default=6.0)
    p.add_argument("--num_clusters", type=int, default=1)
    p.add_argument("--max_times", type=int, default=0)
    p.add_argument("--times", type=str, default=None,
                   help="comma-separated timestamps to mesh (default: "
                        "every distinct test-camera time, like "
                        "render_mesh.py:169-180)")
    p.add_argument("--render_meshes", action="store_true",
                   help="also render mesh_image/ (vertex colours) and "
                        "mesh_shape/ (gray headlight shading) per "
                        "timestamp, like render_mesh.py:227-240")
    args = merge_cfg_args(p.parse_args(argv), argv)
    dev = _device(args)
    cfg, info, state = _restore(args, dev)

    from .mesh.extract import reconstruct_mesh
    from .mesh.tsdf import save_mesh_ply
    times = sorted({float(s.camera.time) for s in info.test_cameras}) \
        or [0.0]
    if args.times:
        times = [float(x) for x in args.times.split(",")]
    elif args.max_times:
        times = times[:args.max_times]
    out = os.path.join(args.model_path, "mesh")
    os.makedirs(out, exist_ok=True)
    train_cams = [s.camera for s in info.train_cameras]
    masks = [s.alpha for s in info.train_cameras]
    for i, t in enumerate(times):
        rep = {}
        verts, faces, colors = reconstruct_mesh(
            train_cams, state.gauss, state.nodes, cfg.node_cfg,
            cfg.raster, mesh_time=t, bg=_bg(cfg, dev), alpha_masks=masks,
            voxel=args.voxel_size, depth_trunc=args.depth_trunc,
            keep_clusters=args.num_clusters, return_colors=True,
            deform_cfg=cfg.deform_cfg, report=rep)
        save_mesh_ply(os.path.join(out, f"mesh_{i:04d}.ply"),
                      verts, faces, colors=colors)
        if args.render_meshes and faces.shape[0] > 0:
            from .mesh.render import write_mesh_renders
            samples = info.test_cameras or info.train_cameras
            write_mesh_renders(samples[min(i, len(samples) - 1)].camera,
                               verts, faces, colors, args.model_path, i,
                               report=rep)
            for sub, key in (("mesh_image", "render_mesh_ms"),
                             ("mesh_shape", "mesh_shape_ms")):
                print(f"{sub}/{i:04d}.png in {rep[key]:.1f} ms", flush=True)
        if report is not None:
            report.setdefault("meshes", []).append(
                dict(rep, time=t, verts=int(verts.shape[0]),
                     faces=int(faces.shape[0]), views=len(train_cams)))
        print(f"t={t:.4f}: {verts.shape[0]} verts "
              f"{faces.shape[0]} faces", flush=True)
        print(f"t={t:.4f}: grid {'x'.join(map(str, rep['dims']))} "
              f"({rep['voxels']} voxels, {rep['bytes']} bytes); "
              f"integrate {rep['integrate_ms']:.1f} ms over "
              f"{len(train_cams)} views, extract {rep['extract_ms']:.1f} "
              f"ms", flush=True)
    return 0


def cmd_edit(argv, report=None) -> int:
    """The editing workflow (the reference's handle-drag path: train_gui.py
    keypoint mode, lap_deform.py:96-226, utils/bezier.py): load a
    checkpoint, pick the control nodes nearest each --handle (ring
    expanded) as the drag group, move it along a bezier drag, ARAP-solve
    the rest of the nodes with the farthest ones anchored, re-skin the
    Gaussians rigidly about the moved nodes (warp_with_bias / p2dR) and
    render the edited frames to PNG (and a GIF).  ``report`` receives
    per frame the solve's and the frame's ms (each between two device
    synchronisations), the handle targets and the solved nodes."""
    p = _base_parser("edit", train_flags=False)
    p.add_argument("--ckpt", type=str, default="ckpt_best.npz")
    p.add_argument("--time", type=float, default=0.0,
                   help="timestamp whose pose is edited")
    p.add_argument("--handle", type=str, action="append", required=True,
                   metavar="X,Y,Z",
                   help="world-space pick; the nearest control node (+ "
                        "--rings ring expansion) becomes the drag group; "
                        "repeatable")
    p.add_argument("--drag", type=str, required=True, metavar="DX,DY,DZ",
                   help="total drag displacement of the handle group")
    p.add_argument("--arc", type=str, default=None, metavar="DX,DY,DZ",
                   help="optional mid-trajectory offset (bezier control "
                        "point) for a curved drag")
    p.add_argument("--rings", type=int, default=1)
    p.add_argument("--n_anchors", type=int, default=16,
                   help="nodes farthest from the drag group held fixed "
                        "in the ARAP solve")
    p.add_argument("--arap_iters", type=int, default=3)
    p.add_argument("--n_frames", type=int, default=16)
    p.add_argument("--gif", action="store_true", default=True)
    p.add_argument("--out", type=str, default="edit")
    args = merge_cfg_args(p.parse_args(argv), argv)
    dev = _device(args)
    cfg, info, state = _restore(args, dev)
    if cfg.deform_type != "node":
        raise SystemExit("cli edit drags control nodes — requires "
                         "--deform_type node (reference editing operates "
                         "on SC-GS control points)")

    import torch
    from PIL import Image

    from .edit import DeformKeypoints, LapDeform
    from .models.nodes import expand_time, node_deform, warp_with_bias
    from .render.renderer import render
    from .utils.bezier import bezier_trajectory
    from .utils.quaternion import quat_multiply, quat_normalize

    g, nodes = state.gauss, state.nodes
    t = torch.tensor(args.time, dtype=torch.float32, device=dev)
    with torch.no_grad():
        attrs = node_deform(nodes, cfg.node_cfg, expand_time(nodes, t))
        cur_t = nodes.nodes[:, :3] + attrs["d_xyz"]          # nodes at t
    cur = cur_t.cpu().numpy()

    # --- keypoint selection: nearest node per pick, ring-expanded ---
    lap = LapDeform(cur_t, K=4, device=dev)
    kp = DeformKeypoints()
    for spec in args.handle:
        pnt = np.asarray([float(v) for v in spec.split(",")], np.float32)
        i = int(np.argmin(((cur - pnt) ** 2).sum(1)))
        kp.add_kpts(cur, lap.add_n_ring_nbs(i, args.rings), expand=True)
    drag_idx, drag_pos = kp.get_kpts()
    rest = np.setdiff1d(np.arange(cur.shape[0]), drag_idx)
    d2 = ((cur[rest][:, None] - cur[drag_idx][None]) ** 2).sum(-1).min(1)
    anchors = rest[np.argsort(-d2)[:min(args.n_anchors, rest.size)]]

    drag = np.asarray([float(v) for v in args.drag.split(",")], np.float32)
    mid = (np.asarray([float(v) for v in args.arc.split(",")], np.float32)
           if args.arc else drag * 0.5)
    traj = bezier_trajectory(
        np.stack([np.zeros(3, np.float32), mid, drag]),
        np.linspace(0.0, 1.0, args.n_frames)).numpy()

    cam = (info.test_cameras or info.train_cameras)[0].camera
    cam = dataclasses.replace(cam, time=t)
    bg = _bg(cfg, dev)

    @torch.no_grad()
    def render_edited(bias):
        d = warp_with_bias(nodes, cfg.node_cfg, g.xyz, t,
                           feature=g.feature, motion_mask=g.motion_mask,
                           node_trans_bias=bias)
        d_rot = d["d_rotation"]
        if "d_rotation_bias" in d:
            q = quat_multiply(d["d_rotation_bias"],
                              quat_normalize(g.rotation + d_rot, eps=1e-12))
            d_rot = q - g.rotation
        out = render(cam, g, bg, d_xyz=d["d_xyz"], d_rotation=d_rot,
                     d_scaling=d["d_scaling"], cfg=cfg.raster)
        return out.image

    out_dir = os.path.join(args.model_path, args.out)
    os.makedirs(out_dir, exist_ok=True)
    hidx = np.concatenate([drag_idx, anchors])
    pils = []
    for f in range(args.n_frames):
        hpos = np.concatenate([drag_pos + traj[f], cur[anchors]])
        _sync(dev)
        t0 = time.perf_counter()
        p_prime, _ = lap.deform_arap(hidx, hpos, n_iters=args.arap_iters)
        _sync(dev)
        t1 = time.perf_counter()
        img = render_edited(p_prime - cur_t)
        arr = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        t2 = time.perf_counter()
        pil = Image.fromarray(arr)
        pil.save(os.path.join(out_dir, f"frame_{f:04d}.png"))
        pils.append(pil)
        if report is not None:
            report.setdefault("solve_ms", []).append((t1 - t0) * 1e3)
            report.setdefault("frame_ms", []).append((t2 - t0) * 1e3)
            report.setdefault("handle_pos", []).append(hpos)
            report.setdefault("solved", []).append(p_prime.cpu().numpy())
        print(f"[edit] frame {f + 1}/{args.n_frames}", flush=True)
    if report is not None:
        report.update(handle_idx=hidx, n_drag=int(drag_idx.size),
                      rest_nodes=cur)
    if args.gif and pils:
        pils[0].save(os.path.join(out_dir, "edit.gif"), save_all=True,
                     append_images=pils[1:], duration=80, loop=0)
    print(f"wrote {args.n_frames} edited frames to {out_dir}")
    return 0


def cmd_mesh_metrics(argv, report=None) -> int:
    """Batch mesh-image PSNR/SSIM eval (reference metrics_mesh.py)."""
    p = argparse.ArgumentParser(prog="d2dgs_torch mesh-metrics")
    p.add_argument("--renders_dir", required=True,
                   help="mesh_image/ directory of re-rendered meshes")
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--name", default="mesh_render")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = _device(args)
    from .eval.mesh_metrics import mesh_image_metrics
    mean = mesh_image_metrics(args.renders_dir, args.gt_dir,
                              args.out_dir or args.renders_dir, args.name,
                              device=dev)
    print(json.dumps(mean, indent=2))
    return 0


def main(argv=None, report=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {"train": cmd_train, "render": cmd_render, "mesh": cmd_mesh,
            "mesh-metrics": cmd_mesh_metrics, "edit": cmd_edit}
    if not argv or argv[0] not in cmds:
        print(f"usage: python -m d2dgs_torch.cli {{{'|'.join(cmds)}}} "
              "[flags]; see --help per command")
        return 2
    return cmds[argv[0]](argv[1:], report)


if __name__ == "__main__":
    raise SystemExit(main())
