"""The system under test: ``d2dgs_torch``, reached through its own entry
points (``Trainer.step``, ``eval.render_sets.render_view``).  This is the
one module of the benchmark that imports the port; everything it hands
the port comes from ``scene``.
"""
from __future__ import annotations

import torch

# TrainConfig's fields that the configuration file sets at the top level
TOP_KEYS = ("sh_degree", "deform_type", "hyper_dim", "node_num", "K",
            "is_blender", "local_frame", "d_rot_as_res", "gaussian_capacity")


def train_config(cfg: dict):
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.train.config import TrainConfig
    return TrainConfig(**{k: cfg[k] for k in TOP_KEYS}, **cfg["train"],
                       raster=RasterConfig(tile_cap=cfg["tile_cap"]))


def camera(rec: dict):
    """The port's Camera of a plain camera record (``scene.camera``)."""
    from d2dgs_torch.data.cameras import Camera
    return Camera(w2c=rec["w2c"], cam_center=rec["cam_center"],
                  fx=rec["fx"], fy=rec["fy"], time=rec["time"], H=rec["H"],
                  W=rec["W"])


@torch.no_grad()
def load_state(gauss, nodes, state: dict) -> None:
    """Copy the benchmark's tensors into the port's Gaussians and its
    node slot (the field's parameters by name), as a checkpoint load
    does."""
    for k, v in state["gauss"].items():
        getattr(gauss, k).copy_(v)
    gauss.active_sh_degree = state["sh_degree"]
    if state["nodes"] is not None:
        for k, v in state["nodes"].items():
            getattr(nodes, k).copy_(v)
    params = dict(nodes.mlp.named_parameters())
    if set(params) != set(state["field"]):
        raise ValueError(f"the port's field has leaves {sorted(params)}, the "
                         f"configuration {sorted(state['field'])}")
    for k, v in state["field"].items():
        params[k].copy_(v)


def leaves(tr) -> dict:
    """The Trainer's trainable leaves by the reference's names."""
    from d2dgs_torch.train.trainer import gauss_trainable, node_trainable
    st = tr.state
    out = {f"gauss.{k}": v for k, v in gauss_trainable(st.gauss).items()}
    out.update({f"field.{k}": v for k, v in st.nodes.mlp.named_parameters()})
    if tr.cfg.deform_type == "node":
        out.update({f"nodes.{k}": v
                    for k, v in node_trainable(st.nodes).items()})
    return out


def first_moments(tr) -> dict:
    """Adam's first moments by the reference's names."""
    st = tr.state
    out = {f"gauss.{k}": v for k, v in st.gauss_opt.mu.items()}
    out.update({f"field.{k}": v for k, v in st.mlp_opt.mu.items()})
    if tr.cfg.deform_type == "node":
        out.update({f"nodes.{k}": v for k, v in st.node_opt.mu.items()})
    return out


def make_trainer(cfg: dict, cams: list, images: list, state: dict,
                 start_iteration: int, seed: int, device):
    """A Trainer on the cell's views, resumed as ``cli train --resume``
    resumes one: built from the scene's point cloud, then its state set
    to ``state`` with fresh Adam moments, at main-stage iteration
    ``start_iteration`` with the node stage done."""
    from d2dgs_torch.train.trainer import Trainer
    n = int(state["gauss"]["alive"].sum())
    pts = state["gauss"]["xyz"][:n].cpu().numpy()
    tr = Trainer(train_config(cfg), [camera(c) for c in cams], images, pts,
                 0.5 * (pts * 0 + 1), cameras_extent=1.1 * float(
                     cams[0]["cam_center"].norm()), seed=seed, device=device)
    load_state(tr.state.gauss, tr.state.nodes, state)
    tr.iteration = start_iteration
    tr.iteration_node = tr.cfg.iterations_node_rendering
    return tr


def make_viewer(cfg: dict, state: dict, device):
    """The port's served model: Gaussians and the field, loaded with
    ``state``; returns ``view(camera record) -> float image [H,W,3]``."""
    from d2dgs_torch.eval.render_sets import render_view
    from d2dgs_torch.models.deform import init_deform
    from d2dgs_torch.models.gaussians import create_from_pcd
    from d2dgs_torch.models.nodes import init_node_params
    tc = train_config(cfg)
    n = int(state["gauss"]["alive"].sum())
    pts = state["gauss"]["xyz"][:n].cpu().numpy()
    gauss = create_from_pcd(pts, pts * 0 + 0.5, tc.gaussian_capacity,
                            sh_degree=tc.sh_degree, fea_dim=tc.hyper_dim,
                            device=device)
    gen = torch.Generator().manual_seed(0)
    nodes = init_node_params(tc.node_cfg, gen, device=device)
    if tc.deform_type != "node":
        nodes.mlp = init_deform(tc.deform_cfg, gen, device)
    load_state(gauss, nodes, state)
    bg = torch.zeros(3, device=device)

    def view(rec: dict):
        return render_view(camera(rec), gauss, nodes, tc.deform_cfg,
                           tc.raster, bg).image
    return view


def blend_launches() -> tuple[int, int]:
    """The port's K1 and K2 launch counters."""
    from d2dgs_torch.ops.cuda.blend import blend_bwd, blend_fwd
    return blend_fwd.launches, blend_bwd.launches


@torch.no_grad()
def render_targets(tr, cams: list, images: list, skip=()) -> None:
    """Each view of the Trainer's scene as it stands, written into
    ``images`` (the targets, rendered once), but those whose index is in
    ``skip``."""
    from d2dgs_torch.eval.render_sets import render_view
    st = tr.state
    bg = torch.zeros(3, device=st.gauss.xyz.device)
    for i, (rec, img) in enumerate(zip(cams, images)):
        if i not in skip:
            img.copy_(render_view(camera(rec), st.gauss, st.nodes,
                                  tr.cfg.deform_cfg, tr.cfg.raster,
                                  bg).image)


def snapshot(tr) -> dict:
    """The Trainer's scene as a plain state (``scene.make_state``'s
    layout), copied."""
    st = tr.state
    g = {k: getattr(st.gauss, k).detach().clone()
         for k in ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity", "feature", "alive")}
    nodes = None
    if tr.cfg.deform_type == "node":
        nodes = {k: getattr(st.nodes, k).detach().clone()
                 for k in ("nodes", "node_radius", "node_weight", "alive")}
    return dict(gauss=g, nodes=nodes,
                field={k: v.detach().clone()
                       for k, v in st.nodes.mlp.named_parameters()},
                sh_degree=st.gauss.active_sh_degree)
