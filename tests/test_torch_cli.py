"""Port parity, the command line: d2dgs_torch.cli's parser, config
reflection and saved-config merge against d2dgs_tpu.cli's, the shared
init-cloud subsampling, the options that are not ported yet, and (slow)
the whole train -> render -> mesh journey on a tiny D-NeRF scene on the
CPU, once in-process and once as ``python -m d2dgs_torch.cli``; and
``mesh --render_meshes`` on that scene."""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from d2dgs_tpu import cli as jcli
from d2dgs_torch import cli as tcli

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)

# JAX RasterConfig fields without a counterpart in the port's (the port
# sizes those buffers from the measured counts; d2dgs_torch/config.py)
JAX_ONLY = {"--raster_emission_cap", "--raster_pair_cap",
            "--raster_use_pallas", "--no-raster_use_pallas",
            "--raster_pallas_interpret", "--no-raster_pallas_interpret"}


def _flags(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("cmd,train_flags", [("train", True),
                                             ("render", False)])
def test_parser_flags_match_jax(cmd, train_flags):
    j = _flags(jcli._base_parser(cmd, train_flags))
    t = _flags(tcli._base_parser(cmd, train_flags))
    assert set(t) == (set(j) - JAX_ONLY) | {"--device"}
    for s in set(t) - {"--device", "-h", "--help"}:
        assert t[s].default == j[s].default, s
        assert t[s].type == j[s].type, s
        assert t[s].required == j[s].required, s
    assert t["--device"].default == "cuda"


def test_config_from_args_matches_jax():
    argv = ["-s", "x", "-m", "y", "--sh_degree", "1", "--node_num", "64",
            "--no-is_blender", "--lambda_dist", "500", "--raster_tile_cap",
            "512", "--no-raster_use_workqueue", "--iterations", "7"]
    jc = jcli.config_from_args(jcli._base_parser("train", True)
                               .parse_args(argv))
    tc = tcli.config_from_args(tcli._base_parser("train", True)
                               .parse_args(argv))
    import dataclasses
    for f in dataclasses.fields(tc):
        if f.name != "raster":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    for f in dataclasses.fields(tc.raster):
        assert getattr(tc.raster, f.name) == getattr(jc.raster, f.name)
    assert tc.node_cfg.node_num == 64 and not tc.is_blender
    with pytest.raises(SystemExit):
        tcli.config_from_args(tcli._base_parser("train", True).parse_args(
            ["-s", "x", "-m", "y", "--deform_type", "warp"]))


def test_cfg_args_merge_matches_jax(tmp_path, monkeypatch):
    saved = argparse.Namespace(model_path=str(tmp_path), node_num=64,
                               hyper_dim=4, lambda_dist=5.0, tag=None)
    tcli.save_cfg_args(str(tmp_path), saved)
    with open(tmp_path / "cfg_args.json") as fh:
        t_json = fh.read()
    jcli.save_cfg_args(str(tmp_path), saved)
    with open(tmp_path / "cfg_args.json") as fh:
        assert fh.read() == t_json
    argv = ["render", "-m", str(tmp_path), "--hyper_dim", "8"]
    monkeypatch.setattr(sys, "argv", argv)
    fresh = lambda: argparse.Namespace(model_path=str(tmp_path),
                                       node_num=1024, hyper_dim=8,
                                       lambda_dist=1.0)
    j = jcli.merge_cfg_args(fresh())
    t = tcli.merge_cfg_args(fresh())
    t2 = tcli.merge_cfg_args(fresh(), argv)
    assert vars(t) == vars(j) == vars(t2)
    assert t.node_num == 64 and t.hyper_dim == 8 and t.lambda_dist == 5.0
    # a model trained with --device cpu: a later eval command still runs on
    # the card unless its own command line says --device cpu
    tcli.save_cfg_args(str(tmp_path), argparse.Namespace(
        model_path=str(tmp_path), node_num=64, device="cpu"))
    with open(tmp_path / "cfg_args.json") as fh:
        assert json.load(fh)["device"] == "cpu"
    eval_args = lambda: argparse.Namespace(model_path=str(tmp_path),
                                           node_num=1024, device="cuda")
    t = tcli.merge_cfg_args(eval_args(), ["render", "-m", str(tmp_path)])
    assert t.device == "cuda" and t.node_num == 64


def test_init_points_match_jax():
    from d2dgs_tpu.train.config import TrainConfig as JTrainConfig
    from d2dgs_torch.data.dnerf import SceneInfo
    from d2dgs_torch.train.config import TrainConfig
    rs = np.random.RandomState(0)
    info = SceneInfo([], [], {"translate": np.zeros(3), "radius": 1.0},
                     rs.rand(500, 3).astype(np.float32),
                     rs.rand(500, 3).astype(np.float32))
    for cap in (200, 2000):
        tp, tc = tcli._init_points(info, TrainConfig(gaussian_capacity=cap),
                                   seed=3)
        jp, jc = jcli._init_points(info, JTrainConfig(gaussian_capacity=cap),
                                   seed=3)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tc, jc)
        assert tp.shape[0] == min(500, cap // 2)


def test_unported_commands_raise(tmp_path):
    """Every command is ported now: a sharded run on a grid of more ranks
    than the run has stops before it reads the scene, naming the ranks
    it needs; no command is left to raise NotImplementedError."""
    for flags in (["--mesh_shape", "2x2"],
                  ["--mesh_shape", "1x4", "--exchange_cap", "4096"]):
        with pytest.raises(SystemExit, match="needs 4 ranks"):
            tcli.main(["train", "-s", str(tmp_path), "-m", str(tmp_path),
                       "--device", "cpu", *flags])
    assert tcli.main([]) == 2


def test_mesh_render_meshes(tmp_path):
    """``mesh --render_meshes`` on a model dir made from the small scene
    without training (the init cloud made opaque): the PLY and both mesh
    renders are written, and the report holds their times."""
    from test_torch_data_io import dnerf_fixture

    from d2dgs_torch.io.checkpoint import save_train_state
    from d2dgs_torch.train.trainer import init_train_state
    root = dnerf_fixture(tmp_path / "scene", n_cams=4, n_times=2, H=32,
                         W=32, n_test=2)
    model = str(tmp_path / "model")
    args = tcli._base_parser("train", True).parse_args(
        ["-s", root, "-m", model, "--device", "cpu", *TINY])
    tcli.save_cfg_args(model, args)
    cfg = tcli.config_from_args(args)
    info = tcli._load_scene(args, torch.device("cpu"))
    state = init_train_state(cfg, *tcli._init_points(info, cfg, 0),
                             device="cpu")
    with torch.no_grad():
        state.gauss.opacity.fill_(4.0)
    save_train_state(os.path.join(model, "ckpt.npz"), state, 1, 1)
    report = {}
    assert tcli.main(["mesh", "-s", root, "-m", model, "--device", "cpu",
                      "--ckpt", "ckpt.npz", "--voxel_size", "0.1",
                      "--max_times", "1", "--render_meshes"],
                     report=report) == 0
    (m,) = report["meshes"]
    assert m["faces"] > 0
    assert m["render_mesh_ms"] > 0 and m["mesh_shape_ms"] > 0
    from PIL import Image
    for sub in ("mesh_image", "mesh_shape"):
        img = np.asarray(Image.open(os.path.join(model, sub, "0000.png")))
        assert img.shape == (32, 32, 3)
        assert (img != 255).any(axis=-1).any()   # not all background


def test_train_with_flow_files(tmp_path, capsys):
    """``train --device cpu`` on a D-NeRF scene with RAFT flow files (one
    per training frame, toward the next, half of them at half size)
    trains with the optical-flow term: its steps log lambda_optical and
    the report counts them."""
    from test_torch_data_io import dnerf_fixture

    from d2dgs_torch.data.synthetic import write_flow_file
    root = dnerf_fixture(tmp_path / "scene", n_cams=2, n_times=2, H=16,
                         W=16, n_test=1, name="{k:03d}")
    rs = np.random.RandomState(0)
    for k in range(3):
        hw = (16, 16) if k % 2 else (8, 8)
        write_flow_file(root, f"{k:03d}", f"{(k + 1) % 3:03d}",
                        rs.normal(size=hw + (2,)).astype(np.float32),
                        rs.uniform(size=hw + (2,)) > 0.3)
    report = {}
    argv = ["train", "-s", root, "-m", str(tmp_path / "m"), "--device",
            "cpu", "--log_every", "1", "--warm_up", "2",
            "--node_warm_up", "2", "--iterations_node_sampling", "3",
            "--iterations_node_rendering", "4", "--iterations", "6",
            "--densify_from_iter", "100", "--oneup_sh_degree_step", "100",
            "--node_force_densify_prune_step", "100",
            "--test_iterations", "-1", "--save_iterations", "-1"] + TINY
    assert tcli.main(argv, report=report) == 0
    out = capsys.readouterr().out
    flow_lines = [ln for ln in out.splitlines() if "lambda_optical=" in ln]
    assert len(flow_lines) == report["flow_steps"] >= 3
    assert "nan" not in out


def test_train_render_hexplane_checkpoint(tmp_path):
    """``train --deform_type hexplane --device cpu`` for a few main-stage
    steps, then ``render`` of its checkpoint.  The checkpoint holds the
    planes and the aabb (a buffer, set from the point cloud): loaded into
    a template built from another cloud, both come back bitwise, and
    written again they give the same arrays."""
    from test_torch_data_io import dnerf_fixture

    from d2dgs_torch.io.checkpoint import load_train_state, save_train_state
    from d2dgs_torch.train.trainer import init_train_state
    root = dnerf_fixture(tmp_path / "scene", n_cams=2, n_times=2, H=16,
                         W=16, n_test=1)
    model = str(tmp_path / "m")
    argv = ["-s", root, "-m", model, "--device", "cpu",
            "--deform_type", "hexplane"] + TINY
    assert tcli.main(["train"] + argv + [
        "--iterations", "3", "--log_every", "1", "--test_iterations", "-1",
        "--save_iterations", "-1"]) == 0
    ckpt = os.path.join(model, "ckpt.npz")
    report = {}
    assert tcli.main(["render"] + argv + ["--ckpt", "ckpt.npz"],
                     report=report) == 0
    assert report["view_ms"] > 0
    cfg = tcli.config_from_args(tcli._base_parser("train", True).parse_args(
        ["-s", root, "-m", model, "--deform_type", "hexplane"] + TINY))
    rs = np.random.RandomState(1)
    template = init_train_state(cfg, rs.uniform(-3, 3, (50, 3)),
                                rs.uniform(0, 1, (50, 3)), device="cpu")
    state, it, _ = load_train_state(ckpt, template)
    assert it == 5                  # four main-stage steps from 1
    field = state.nodes.mlp
    with np.load(ckpt) as z:
        aabb = z["leaf:.nodes.mlp['aabb']"]
        assert not np.array_equal(aabb, np.stack([np.full(3, 3.0)] * 2))
        np.testing.assert_array_equal(field.aabb.numpy(), aabb)
        for name, p in field.named_parameters():
            key = "leaf:.nodes.mlp" + "".join(
                f"[{q}]" if q.isdigit() else f"['{q}']"
                for q in name.split("."))
            np.testing.assert_array_equal(p.detach().numpy(), z[key],
                                          err_msg=name)
        again = str(tmp_path / "again.npz")
        save_train_state(again, state, it, 0)
        with np.load(again) as y:
            for k in ("leaf:.nodes.mlp['aabb']",
                      "leaf:.nodes.mlp['grids'][1]['time']"):
                np.testing.assert_array_equal(y[k], z[k], err_msg=k)


# ----------------------------------------------------------------------
# the journey (slow)
# ----------------------------------------------------------------------

TINY = ["--sh_degree", "1", "--hyper_dim", "2", "--node_num", "16",
        "--gaussian_capacity", "512", "--node_gauss_capacity", "256",
        "--raster_tile_cap", "256", "--raster_chunk", "64"]
SCHEDULE = ["--warm_up", "30", "--node_warm_up", "60",
            "--iterations_node_sampling", "120",
            "--iterations_node_rendering", "160", "--iterations", "60",
            "--densification_interval", "25", "--densify_from_iter", "20",
            "--opacity_reset_interval", "10000",
            "--normal_dist_from_iter", "40",
            "--node_force_densify_prune_step", "1000"]


@pytest.mark.slow
def test_cli_train_render_mesh_journey(tmp_path):
    """train (with the motion-mask loss on, a test and a save iteration)
    -> resume -> render (test and time modes, the latter through
    ``python -m``) -> mesh, all with --device cpu."""
    from test_torch_data_io import dnerf_fixture

    from d2dgs_torch.io.ply import load_gaussian_ply
    root = dnerf_fixture(tmp_path / "scene", n_cams=6, n_times=3, H=48,
                         W=48, n_test=4)
    model = str(tmp_path / "model")
    common = ["-s", root, "-m", model, "--device", "cpu", *TINY]
    report = {}
    assert tcli.main(["train", *common, *SCHEDULE,
                      "--gt_alpha_mask_as_dynamic_mask",
                      "--test_iterations", "50", "--save_iterations", "50",
                      "--log_every", "50"], report=report) == 0
    assert len(report["step_ms"]) == 60 + 160   # main + node stage steps
    for f in ("ckpt.npz", "ckpt_best.npz", "cfg_args.json",
              "point_cloud/iteration_50/point_cloud.ply",
              "training_renders/iter_50/view_00.png"):
        assert os.path.exists(os.path.join(model, f)), f
    ply = load_gaussian_ply(
        os.path.join(model, "point_cloud/iteration_50/point_cloud.ply"),
        capacity=512, sh_degree=1, fea_dim=2, with_motion_mask=True,
        device="cpu")
    assert int(ply.num_alive) > 0

    # resume: two more main-stage steps from the saved checkpoint
    assert tcli.main(["train", *common, *SCHEDULE,
                      "--gt_alpha_mask_as_dynamic_mask", "--iterations",
                      "62", "--resume", os.path.join(model, "ckpt.npz"),
                      "--test_iterations", "0", "--save_iterations", "0"]) \
        == 0
    with np.load(os.path.join(model, "ckpt.npz")) as z:
        assert int(z["__iteration__"]) == 64   # 62 after the first run

    report = {}
    assert tcli.main(["render", "-s", root, "-m", model, "--device", "cpu",
                      "--ckpt", "ckpt.npz"], report=report) == 0
    assert report["view_ms"] > 0
    with open(os.path.join(model, "results.json")) as fh:
        res = json.load(fh)
    assert set(res) == {"psnr", "ssim", "ms_ssim", "lpips_rand"}
    assert np.isfinite(res["psnr"]) and res["psnr"] > 15
    assert len(os.listdir(os.path.join(model, "test", "renders",
                                       "renders"))) == 4

    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(tcli.__file__))))
    r = subprocess.run([sys.executable, "-m", "d2dgs_torch.cli", "render",
                        "-s", root, "-m", model, "--device", "cpu",
                        "--ckpt", "ckpt.npz", "--mode", "time",
                        "--n_frames", "3"], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert os.path.exists(os.path.join(model, "time", "video.gif"))

    # this short schedule leaves splats far outside the cameras' view (as
    # the JAX package's does: tests/test_cli.py), so the automatic box is
    # tens of units wide: a coarse voxel keeps the grid small
    report = {}
    assert tcli.main(["mesh", "-s", root, "-m", model, "--device", "cpu",
                      "--ckpt", "ckpt.npz", "--voxel_size", "0.5",
                      "--max_times", "1", "--render_meshes"],
                     report=report) == 0
    from d2dgs_torch.mesh.tsdf import load_mesh_ply
    v, f = load_mesh_ply(os.path.join(model, "mesh", "mesh_0000.ply"))
    assert v.shape[1] == 3 and f.shape[1] == 3
    (m,) = report["meshes"]
    assert (m["verts"], m["faces"]) == (v.shape[0], f.shape[0])
    with open(os.path.join(root, "transforms_train.json")) as fh:
        n_train = len(json.load(fh)["frames"])
    assert m["voxels"] == int(np.prod(m["dims"])) and m["views"] == n_train
    if m["faces"]:
        for sub in ("mesh_image", "mesh_shape"):
            assert os.path.exists(os.path.join(model, sub, "0000.png"))
