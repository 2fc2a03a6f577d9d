"""Rank bodies of the port's multi-process CPU tests (gloo), run by
``d2dgs_torch.parallel.multihost.run_local`` in spawned processes.  They
import the port, torch and numpy only (a spawned rank imports this module
by name), read their inputs from an ``.npz`` the test wrote, and rank 0
writes what the test compares with ``torch.save``."""
import numpy as np
import torch
import torch.distributed as dist

from d2dgs_torch.config import RasterConfig
from d2dgs_torch.data.cameras import Camera
from d2dgs_torch.models.regularizers import ArapDraws
from d2dgs_torch.parallel import (gather_gauss_state, make_dp_main_step,
                                  make_mesh2d, measure_exchange_counts,
                                  render_gauss_sharded, shard_gauss_state,
                                  shard_gaussians, sharded_train_step,
                                  suggest_exchange_cap)
from d2dgs_torch.train.trainer import (GAUSS_FIELDS, NODE_FIELDS,
                                       mlp_trainable)

SCENE_KEYS = ("means", "scales", "quats", "opacity", "colors", "alive")


def camera_arrays(cam, prefix="cam_") -> dict:
    """A camera's fields as numpy arrays (for an ``.npz``)."""
    out = {f"{prefix}{k}": np.asarray(getattr(cam, k), np.float32)
           for k in ("w2c", "cam_center", "fx", "fy", "time")}
    out[f"{prefix}hw"] = np.asarray([cam.H, cam.W])
    return out


def camera_from(z, prefix="cam_") -> Camera:
    t = lambda k: torch.tensor(np.asarray(z[prefix + k], np.float32))
    H, W = (int(v) for v in z[prefix + "hw"])
    return Camera(w2c=t("w2c"), cam_center=t("cam_center"), fx=t("fx"),
                  fy=t("fy"), time=t("time"), H=H, W=W)


def _gather(x):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def render_ranks(rank, inp, out):
    """The sharded render of one view: image, allmap, overflow and the
    gradients of mean((image - 0.5)^2) in means and opacity (gathered),
    then the same view at ``exchange_cap`` 2 (its overflow)."""
    z = dict(np.load(inp))
    D = dist.get_world_size()
    sc = shard_gaussians(D, rank, [torch.tensor(z[k]) for k in SCENE_KEYS])
    means, opac = (sc[0].clone().requires_grad_(),
                   sc[3].clone().requires_grad_())
    cam = camera_from(z)
    cfg = RasterConfig(tile_cap=256, chunk=64)
    bg = torch.tensor(z["bg"])
    r = render_gauss_sharded(dist.group.WORLD, cam, means, sc[1], sc[2],
                             opac, sc[4], sc[5], bg, cfg=cfg)
    gm, go = torch.autograd.grad(torch.mean((r.image - 0.5) ** 2),
                                 [means, opac])
    gm, go = _gather(gm), _gather(go)
    with torch.no_grad():
        small = render_gauss_sharded(dist.group.WORLD, cam, *sc, bg, cfg=cfg,
                                     exchange_cap=2)
        counts = measure_exchange_counts(
            dist.group.WORLD, cam, sc[0], sc[1], sc[2], sc[5], cfg,
            opacity=sc[3], full=True)
    if rank == 0:
        torch.save(dict(image=r.image.detach(), allmap=r.allmap.detach(),
                        overflow=int(r.overflow), d_means=gm, d_opacity=go,
                        overflow_cap2=int(small.overflow), counts=counts),
                   out)


def load_state(z):
    """The carried-across TrainState of the test's ``.npz``."""
    from d2dgs_torch.io.from_jax import train_state_from_jax_arrays
    leaves = {k[len("leaf:"):]: v for k, v in z.items()
              if k.startswith("leaf:")}
    return train_state_from_jax_arrays(leaves, device="cpu")


def draws_arrays(draws: ArapDraws, i: int = 0) -> dict:
    """An ARAP term's draws as numpy arrays (for an ``.npz``)."""
    return {f"draw{i}_{f}": v.numpy() for f, v in draws._asdict().items()
            if v is not None}


def draws_from(z, i: int = 0) -> ArapDraws:
    return ArapDraws(*(torch.tensor(z[f"draw{i}_{f}"])
                       if f"draw{i}_{f}" in z else None
                       for f in ArapDraws._fields))


def state_summary(state) -> dict:
    """What the tests compare of a (whole) TrainState."""
    g = state.gauss
    return dict(
        gauss={k: getattr(g, k).detach().clone() for k in GAUSS_FIELDS},
        alive=g.alive.clone(),
        stats=[t.clone() for t in state.gauss_stats],
        mu={k: v.clone() for k, v in state.gauss_opt.mu.items()},
        mlp={k: v.detach().clone()
             for k, v in mlp_trainable(state.nodes).items()},
        mlp_mu={k: v.clone() for k, v in state.mlp_opt.mu.items()},
        nodes={k: getattr(state.nodes, k).detach().clone()
               for k in NODE_FIELDS})


def sharded_step_ranks(rank, inp, out, shape, steps):
    """``steps`` sharded steps on the (n_data x n_gauss) grid ``shape``:
    step s trains cameras cam{s * n_data + i} with draws ``draw{s}``."""
    z = dict(np.load(inp))
    cfg = train_cfg(z)
    mesh = make_mesh2d(*shape)
    state = shard_gauss_state(mesh, load_state(z))
    sched = {k[len("sched_"):]: float(v) for k, v in z.items()
             if k.startswith("sched_")}
    n_data = shape[0]
    metrics, summaries = [], []
    for s in range(steps):
        idx = range(s * n_data, (s + 1) * n_data)
        cams = [camera_from(z, f"cam{i}_") for i in idx]
        gts = torch.stack([torch.tensor(z[f"gt{i}"]) for i in idx])
        state, m = sharded_train_step(state, cams, gts, sched, cfg, mesh,
                                      int(z["exchange_cap"]),
                                      arap_draws=draws_from(z, s))
        metrics.append({k: float(v) for k, v in m.items()})
        summaries.append(state_summary(gather_gauss_state(mesh, state)))
    # the replicated leaves must be the same on every rank
    mlp = torch.cat([v.reshape(-1) for v in summaries[-1]["mlp"].values()])
    spread = mlp.clone()
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    if rank == 0:
        torch.save(dict(summaries=summaries, metrics=metrics,
                        replicated_spread=float((spread - mlp).abs().max())),
                   out)


def train_cfg(z):
    from d2dgs_torch.train.config import TrainConfig
    return TrainConfig(sh_degree=1, hyper_dim=2, node_num=16,
                       gaussian_capacity=int(z["capacity"]),
                       node_gauss_capacity=64, warm_up=0,
                       raster=RasterConfig(tile_cap=256, chunk=64))


def autosize_ranks(rank, inp, out):
    """The exchange's measured counts and suggested cap on a 1 x D grid,
    and the overflow of a render at that cap."""
    z = dict(np.load(inp))
    D = dist.get_world_size()
    sc = shard_gaussians(D, rank, [torch.tensor(z[k]) for k in SCENE_KEYS])
    cams = [camera_from(z, f"cam{i}_") for i in range(2)]
    cfg = RasterConfig(tile_cap=256, chunk=64)
    g = dist.group.WORLD
    mx = measure_exchange_counts(g, cams[0], sc[0], sc[1], sc[2], sc[5],
                                 cfg)
    cap = suggest_exchange_cap(g, cams, sc[0], sc[1], sc[2], sc[5], cfg)
    with torch.no_grad():
        r = render_gauss_sharded(g, cams[0], sc[0], sc[1], sc[2], sc[3],
                                 torch.zeros_like(sc[4]), sc[5],
                                 torch.zeros(3), cfg=cfg, exchange_cap=cap)
    if rank == 0:
        torch.save(dict(max_count=mx, cap=cap, overflow=int(r.overflow)),
                   out)


def dp_step_ranks(rank, inp, out, batch):
    """One data-parallel step of a ``batch``-camera batch over the ranks."""
    z = dict(np.load(inp))
    cfg = train_cfg(z)
    state = load_state(z)
    sched = {k[len("sched_"):]: float(v) for k, v in z.items()
             if k.startswith("sched_")}
    cams = [camera_from(z, f"cam{i}_") for i in range(batch)]
    gts = torch.stack([torch.tensor(z[f"gt{i}"]) for i in range(batch)])
    step = make_dp_main_step(cfg)
    state, m = step(state, cams, gts, sched, arap_draws=draws_from(z))
    xyz = state.gauss.xyz.detach().clone()
    spread = xyz.clone()
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    if rank == 0:
        torch.save(dict(summary=state_summary(state),
                        metrics={k: float(v) for k, v in m.items()},
                        replicated_spread=float((spread - xyz).abs().max())),
                   out)


def trainer_ranks(rank, inp, out, shape, steps):
    """A Trainer from the test's point cloud and video, sharded on the
    grid ``shape``, for ``steps`` steps (its node stage replicated)."""
    z = dict(np.load(inp))
    tr = make_trainer(z)
    tr.enable_sharded_training(shape, exchange_cap=int(z["exchange_cap"]))
    losses, overflow = [], 0
    for _ in range(steps):
        m = tr.step()
        if m:
            losses.append(float(m["loss"]))
            overflow += int(m.get("overflow", 0))
    full = tr.full_state()
    if rank == 0:
        torch.save(dict(summary=state_summary(full), losses=losses,
                        overflow=overflow, iteration=tr.iteration), out)


def make_trainer(z):
    """The tests' tiny Trainer (the schedule of tests/test_sharded_train.py
    ``test_trainer_sharded_main_stage``) from the arrays of ``z``."""
    import dataclasses

    from d2dgs_torch.train.trainer import Trainer
    cfg = dataclasses.replace(
        train_cfg(z), deform_type="node", iterations=8, warm_up=0,
        iterations_node_rendering=2, iterations_node_sampling=1,
        node_warm_up=1, densify_from_iter=2, densify_until_iter=8,
        densification_interval=3, opacity_reset_interval=1000,
        node_force_densify_prune_step=1000, normal_dist_from_iter=1)
    n = int(z["n_cams"])
    cams = [camera_from(z, f"cam{i}_") for i in range(n)]
    imgs = [z[f"gt{i}"] for i in range(n)]
    return Trainer(cfg, cams, imgs, z["points"], z["colors"],
                   cameras_extent=4.0, seed=0, device="cpu")


def cli_ranks(rank, argv, out):
    """``cli train`` on every rank of the group."""
    from d2dgs_torch import cli
    report = {}
    rc = cli.main(argv, report=report)
    if rank == 0:
        torch.save(dict(rc=rc, report=report), out)
