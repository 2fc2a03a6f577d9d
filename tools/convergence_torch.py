"""Convergence and mesh-quality gate of the PyTorch/CUDA port on the
articulated figure (the port's counterpart of tools/convergence_bench.py,
with the same widths, schedule, seeds, mesh times, floors and ceiling).

Renders the procedural articulated figure (d2dgs_torch/data/articulated.py:
60,000 ground-truth surfels, 12 cameras x 8 times at 800x800, through K1),
trains the two-stage recipe on it with the port's ``Trainer`` on the
work-queue route (K1/K2): 1,250 stage-1 and 15,000 main-stage iterations,
capacity 120,000, 1,024 control nodes and the 8x256 deform MLP.  Then it
scores the held-out views (every 10th), exports the dataset as a D-NeRF
directory and the model as ``cfg_args.json`` plus a format-2 checkpoint,
meshes through the user's own ``cli mesh --render_meshes`` at voxel 0.008
and t = 0, 4/7 and 1, and scores each mesh's chamfer distance against the
scene's exact surface samples at that time, with both one-sided parts and
the ground truth -> mesh distance per part of the figure.

Writes CONVERGENCE_torch.json and MESH_torch.json at the repository root
(the keys of CONVERGENCE_r05.json and MESH_r05.json, plus "device": the
card's name and power limit) and exits non-zero if a floor is missed:
test PSNR > 27.0, at least 30,000 Gaussians alive, chamfer <= 0.045 at
every mesh time.

Run on the card from the repository root:

    python3 tools/convergence_torch.py            # the full schedule
    python3 tools/convergence_torch.py --fast     # 200 + 600 iterations
    python3 tools/convergence_torch.py --resume   # continue a stopped run

The run keeps its state in .conv_torch_run/ (untracked): every 1,000
steps and at the end, a format-2 checkpoint with the iteration counters
and Adam's moments, and progress.json with the trajectory, the camera
sampler's state and the training time so far.  ``--resume`` continues a
run that was stopped (a call's time limit, a lost machine) from its last
checkpoint, on the same camera sequence, and ``wall_train_s`` sums the
training time of every part.  ``--fast`` cuts the schedule only (the
widths stay): a smoke run, too short for the floors, which it does not
check.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

from d2dgs_torch.config import RasterConfig  # noqa: E402
from d2dgs_torch.train.config import TrainConfig  # noqa: E402

RUN_DIR = os.path.join(ROOT, ".conv_torch_run")
CKPT_EVERY = 1_000

SIZE = dict(H=800, W=800, n_surfels=60_000, n_cams=12, n_times=8)

# the JAX gate's TrainConfig (tools/convergence_bench.py): the reference
# schedule scaled ~1:8 (main stage 1:5.3) with the reference's 1,024
# nodes; the port has no emission_cap or pair_cap
CFG = TrainConfig(
    sh_degree=3, hyper_dim=8, node_num=1024, K=3,
    gaussian_capacity=120_000, node_gauss_capacity=8_192,
    iterations=15_000, warm_up=375, node_warm_up=250,
    iterations_node_sampling=950, iterations_node_rendering=1_250,
    densification_interval=100, densify_from_iter=62,
    densify_until_iter=9_375, opacity_reset_interval=1_500,
    normal_dist_from_iter=1_000, oneup_sh_degree_step=125,
    node_force_densify_prune_step=1_250,
    raster=RasterConfig(tile_cap=2048, chunk=64),
)
# --fast: the JAX gate's --fast schedule at the full widths
FAST = dict(iterations=600, iterations_node_sampling=150,
            iterations_node_rendering=200, densify_until_iter=400)

MESH_TIMES = (0.0, 4.0 / 7.0, 1.0)
PSNR_FLOOR = 27.0
ALIVE_FLOOR = 30_000
CHAMFER_CEIL = 0.045   # world units; the figure is ~2.4 units tall
MESH_VOXEL = 0.008


def train_config(fast: bool = False) -> TrainConfig:
    return dataclasses.replace(CFG, **FAST) if fast else CFG


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": power}


def make_data(device, H, W, n_surfels, n_cams, n_times):
    """The ground-truth video (seed 0), its test split (every 10th view)
    and the initial cloud: half the capacity's points uniform in the t=0
    figure's box padded by 0.15, grey (np.random.RandomState(0))."""
    from d2dgs_torch.data.articulated import make_articulated_dataset
    cams, imgs, alphas, scene, _ = make_articulated_dataset(
        0, n_cams=n_cams, n_times=n_times, H=H, W=W, n_surfels=n_surfels,
        device=device)
    test_idx = set(range(0, len(cams), 10))
    p0, _ = scene.surfel_positions(0.0)
    lo, hi = p0.min(0) - 0.15, p0.max(0) + 0.15
    return dict(cams=cams, imgs=imgs, alphas=alphas, scene=scene,
                test_idx=test_idx, box=(lo, hi))


def init_cloud(box, n: int):
    lo, hi = box
    rng = np.random.RandomState(0)
    pts = rng.rand(n, 3).astype(np.float32) * (hi - lo) + lo
    return pts, np.full((n, 3), 0.5, np.float32)


def make_trainer(cfg, data, device):
    from d2dgs_torch.train.trainer import Trainer
    keep = [k for k in range(len(data["cams"])) if k not in data["test_idx"]]
    pts, cols = init_cloud(data["box"], cfg.gaussian_capacity // 2)
    return Trainer(cfg, [data["cams"][k] for k in keep],
                   [data["imgs"][k] for k in keep], pts, cols,
                   cameras_extent=3.0, seed=0, device=device)


def new_progress(fast: bool = False) -> dict:
    return {"fast": fast, "wall_train_s": 0.0, "trajectory": []}


def steps_done(tr) -> int:
    return tr.iteration_node + tr.iteration - 2


def save_progress(tr, progress: dict, run_dir: str = RUN_DIR) -> None:
    """Saves the run at its current step: the TrainState to a new
    state_NNNNNN.npz, then progress.json naming it (replaced atomically),
    then the older state files.  A run stopped at any point leaves a
    progress.json whose state file is whole."""
    from d2dgs_torch.io.checkpoint import save_train_state
    os.makedirs(run_dir, exist_ok=True)
    name = f"state_{steps_done(tr):06d}.npz"
    save_train_state(os.path.join(run_dir, name), tr.state, tr.iteration,
                     tr.iteration_node)
    progress.update(state=name, sampler=tr.sampler_state())
    tmp = os.path.join(run_dir, "progress.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(progress, fh)
    os.replace(tmp, os.path.join(run_dir, "progress.json"))
    for f in os.listdir(run_dir):
        if f.startswith("state_") and f != name:
            os.remove(os.path.join(run_dir, f))


def load_progress(tr, run_dir: str = RUN_DIR) -> dict:
    """Puts ``tr`` (a new Trainer of the same configuration and data)
    where the last save_progress left the run, and returns the progress."""
    from d2dgs_torch.io.checkpoint import load_train_state
    with open(os.path.join(run_dir, "progress.json")) as fh:
        progress = json.load(fh)
    tr.state, tr.iteration, tr.iteration_node = load_train_state(
        os.path.join(run_dir, progress["state"]), tr.state)
    tr.set_sampler_state(progress["sampler"])
    return progress


def train(tr, progress: dict, run_dir: str = RUN_DIR,
          ckpt_every: int = CKPT_EVERY, log=print) -> None:
    """Runs the schedule from where ``tr`` stands to its end, saving the
    run every ``ckpt_every`` steps and at the end.  The time of the saves
    is not training time."""
    total = tr.total_iterations()
    dev = tr.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t_lap = time.time()
    while steps_done(tr) < total:
        m = tr.step()
        tick = steps_done(tr)
        if m and tick % 100 == 0:
            p, alive = float(m["psnr"]), int(m.get("alive", 0))
            progress["trajectory"].append(
                {"iter": tick, "psnr": round(p, 3), "alive": alive,
                 "iter_time_ms": round(m.get("iter_time_ms", 0), 2)})
            log(f"[{tick}/{total}] psnr={p:.2f} alive={alive} "
                f"pairs={int(m.get('num_pairs', 0))} "
                f"of={int(m.get('overflow', 0))} "
                f"t={progress['wall_train_s'] + time.time() - t_lap:.0f}s")
        if tick % ckpt_every == 0 or tick == total:
            sync()
            progress["wall_train_s"] += time.time() - t_lap
            save_progress(tr, progress, run_dir)
            t_lap = time.time()


def export_dnerf_dataset(cams, imgs, alphas, test_idx, root):
    """The in-memory dataset as a D-NeRF directory (RGBA PNGs and
    transforms_{train,test}.json with per-frame time), so ``cli mesh``
    goes through the user's reader."""
    from d2dgs_torch.data.synthetic import write_dnerf_scene
    splits = {"train": [], "test": []}
    for k, (cam, img, al) in enumerate(zip(cams, imgs, alphas)):
        rgba = np.concatenate([img, al.reshape(img.shape[0], img.shape[1],
                                               1)], -1)
        splits["test" if k in test_idx else "train"].append((cam, rgba))
    write_dnerf_scene(root, splits)


def write_model_dir(cfg, tr, model_dir, data_dir):
    """cfg_args.json and ckpt.npz: what ``cli train`` leaves behind."""
    from d2dgs_torch.cli import _base_parser, save_cfg_args
    from d2dgs_torch.io.checkpoint import save_train_state
    ns = _base_parser("train", train_flags=False).parse_args(
        ["-s", data_dir, "-m", model_dir])
    for f in dataclasses.fields(TrainConfig):
        if isinstance(getattr(cfg, f.name, None), (int, float, str, bool)):
            setattr(ns, f.name, getattr(cfg, f.name))
    for f in dataclasses.fields(RasterConfig):
        setattr(ns, "raster_" + f.name, getattr(cfg.raster, f.name))
    ns.device = tr.device.type
    save_cfg_args(model_dir, ns)
    save_train_state(os.path.join(model_dir, "ckpt.npz"), tr.state,
                     tr.iteration, tr.iteration_node)


def mesh_and_score(cfg, tr, data, times, run_dir, log=print) -> dict:
    """Mesh at ``times`` through ``cli mesh --render_meshes`` (the D-NeRF
    reader, the checkpoint restore, the masked median-depth TSDF, the
    PLY, the mesh renders) and score each mesh against the scene's exact
    surface samples at its time."""
    from d2dgs_torch import cli
    from d2dgs_torch.eval.mesh_metrics import score_mesh
    from d2dgs_torch.mesh.tsdf import load_mesh_ply
    data_dir = os.path.join(run_dir, "data")
    model_dir = os.path.join(run_dir, "model")
    t0 = time.time()
    export_dnerf_dataset(data["cams"], data["imgs"], data["alphas"],
                         data["test_idx"], data_dir)
    write_model_dir(cfg, tr, model_dir, data_dir)
    log(f"[export] D-NeRF dataset and model dir in {time.time() - t0:.1f} s")
    report = {}
    rc = cli.main(["mesh", "-s", data_dir, "-m", model_dir,
                   "--ckpt", "ckpt.npz", "--voxel_size", str(MESH_VOXEL),
                   "--num_clusters", "16", "--render_meshes",
                   "--device", tr.device.type,
                   "--times", ",".join(str(t) for t in times)],
                  report=report)
    if rc != 0:
        raise RuntimeError(f"cli mesh exited {rc}")
    scene = data["scene"]
    parts = [(p.name, len(p.pos)) for p in scene.parts]
    out = {"voxel": MESH_VOXEL, "via": "cli mesh", "times": [],
           "chamfer": [], "pred_to_gt": [], "gt_to_pred": [], "n_verts": [],
           "ceil": CHAMFER_CEIL, "gt_to_pred_by_part": [], "cli": []}
    for i, (t, rep) in enumerate(zip(times, report["meshes"])):
        verts, faces = load_mesh_ply(os.path.join(model_dir, "mesh",
                                                  f"mesh_{i:04d}.ply"))
        gt_pts, _ = scene.surfel_positions(t)
        s = score_mesh(verts, faces, gt_pts, parts, device=tr.device)
        out["times"].append(float(t))
        out["chamfer"].append(round(s["chamfer"], 5))
        out["pred_to_gt"].append(round(s["pred_to_gt"], 5))
        out["gt_to_pred"].append(round(s["gt_to_pred"], 5))
        out["n_verts"].append(int(verts.shape[0]))
        out["gt_to_pred_by_part"].append(
            {k: round(v, 4) for k, v in s["by_part"].items()})
        out["cli"].append({k: rep[k] for k in (
            "faces", "dims", "integrate_ms", "extract_ms", "render_mesh_ms",
            "mesh_shape_ms") if k in rep})
        log(f"[mesh t={t:.4f}] verts={verts.shape[0]} chamfer="
            f"{s['chamfer']:.4f} (pred->gt {s['pred_to_gt']:.4f}, gt->pred "
            f"{s['gt_to_pred']:.4f}); gt->pred by part "
            f"{out['gt_to_pred_by_part'][-1]}")
    return out


def test_metrics(tr, data) -> dict:
    from d2dgs_torch.eval.render_sets import render_test_set
    test = [(c, i) for k, (c, i) in enumerate(zip(data["cams"],
                                                   data["imgs"]))
            if k in data["test_idx"]]
    res = render_test_set(test, tr.state.gauss, tr.state.nodes,
                          tr.cfg.node_cfg, tr.cfg.raster,
                          bg=torch.zeros(3), save_images=False,
                          deform_cfg=tr.cfg.deform_cfg)
    return {k: v for k, v in res["mean"].items() if isinstance(v, float)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="the cut schedule (200 + 600 iterations) at the "
                         "full widths; the floors are not checked")
    ap.add_argument("--resume", action="store_true",
                    help="continue from .conv_torch_run/")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tools/convergence_torch.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = train_config(args.fast)
    dev_info = card()
    print(f"{dev_info['name']}, {dev_info['power_limit']}", flush=True)

    t_gen = time.time()
    data = make_data(dev, **SIZE)
    gen_s = time.time() - t_gen
    print(f"[gen] {len(data['cams'])} views of {data['scene'].n_surfels} GT "
          f"surfels in {gen_s:.1f} s", flush=True)
    tr = make_trainer(cfg, data, dev)
    progress = new_progress(args.fast)
    if args.resume:
        progress = load_progress(tr)
        if progress["fast"] != args.fast:
            raise SystemExit("--resume: the saved run's --fast differs")
        print(f"[resume] at node iteration {tr.iteration_node}, main "
              f"iteration {tr.iteration}, {progress['wall_train_s']:.0f} s "
              f"trained", flush=True)
    train(tr, progress, log=lambda s: print(s, flush=True))

    final = test_metrics(tr, data)
    alive = int(tr.state.gauss.num_alive)
    print(f"[test] {json.dumps(final)} alive={alive}", flush=True)
    times = (0.0,) if args.fast else MESH_TIMES
    mesh_out = mesh_and_score(cfg, tr, data, times, RUN_DIR,
                              log=lambda s: print(s, flush=True))
    mesh_out["device"] = dev_info
    conv = {
        "config": {"H": SIZE["H"], "W": SIZE["W"],
                   "n_views": len(data["cams"]),
                   "n_gt_surfels": data["scene"].n_surfels,
                   "scene": "articulated figure (data/articulated.py, "
                            "seed 0)",
                   "n_init": cfg.gaussian_capacity // 2,
                   "capacity": cfg.gaussian_capacity,
                   "node_num": cfg.node_cfg.node_num,
                   "iterations": cfg.iterations,
                   "node_iterations": cfg.iterations_node_rendering,
                   "device": torch.cuda.get_device_name(0),
                   "wall_train_s": round(progress["wall_train_s"], 1),
                   "gen_s": round(gen_s, 1)},
        "final_test": {k: round(v, 4) for k, v in final.items()},
        "alive": alive,
        "floors": {"psnr": PSNR_FLOOR, "alive": ALIVE_FLOOR},
        "mesh_voxel": MESH_VOXEL,
        "trajectory": progress["trajectory"],
        "device": dev_info,
    }
    suffix = "_fast" if args.fast else ""
    for name, obj in (("CONVERGENCE", conv), ("MESH", mesh_out)):
        path = os.path.join(ROOT, f"{name}_torch{suffix}.json")
        with open(path, "w") as fh:
            json.dump(obj, fh, indent=1)
        print(f"wrote {path}", flush=True)
    if args.fast:
        return 0
    missed = []
    if not final["psnr"] > PSNR_FLOOR:
        missed.append(f"PSNR {final['psnr']:.3f} <= {PSNR_FLOOR}")
    if alive < ALIVE_FLOOR:
        missed.append(f"alive {alive} < {ALIVE_FLOOR}")
    if not max(mesh_out["chamfer"]) <= CHAMFER_CEIL:
        missed.append(f"chamfer {mesh_out['chamfer']} > {CHAMFER_CEIL}")
    if missed:
        print("FLOORS MISSED: " + "; ".join(missed), flush=True)
        return 1
    print("ALL FLOORS PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
