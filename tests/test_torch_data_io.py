"""Port parity, data and io: the D-NeRF reader's SceneInfo, format-2
checkpoints written by either package and loaded by the other, and the
Gaussian PLY bytes, d2dgs_torch against d2dgs_tpu on the same inputs.
Every comparison here is exact: the reader, the checkpoint and the PLY
move float32 arrays without arithmetic, and the init cloud comes from the
same np.random.RandomState draws."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2dgs_tpu.data import dnerf as jdnerf
from d2dgs_tpu.io import checkpoint as jckpt
from d2dgs_tpu.io import ply as jply
from d2dgs_tpu.train import trainer as jtrainer
from d2dgs_tpu.train.config import TrainConfig as JTrainConfig
from d2dgs_torch.data import dnerf as tdnerf
from d2dgs_torch.data.synthetic import make_video_dataset, write_dnerf_scene
from d2dgs_torch.io import checkpoint as tckpt
from d2dgs_torch.io import ply as tply
from d2dgs_torch.models.gaussians import GaussianParams
from d2dgs_torch.train import trainer as ttrainer
from d2dgs_torch.train.trainer import GAUSS_FIELDS
from d2dgs_torch.train.config import TrainConfig

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)


def dnerf_fixture(root, n_cams=4, n_times=3, H=40, W=40, n_test=3,
                  name="r_{k}"):
    """A D-NeRF scene rendered from the port's synthetic video, alpha from
    the image's coverage, the last ``n_test`` frames held out; frame k is
    named ``name.format(k=k)``."""
    cams, imgs, _, _ = make_video_dataset(3, n_cams=n_cams, n_times=n_times,
                                          H=H, W=W, n_gauss=16, device="cpu")
    rgba = [np.concatenate([im, (im.sum(-1, keepdims=True) > 0.02)
                            .astype(np.float32)], -1) for im in imgs]
    frames = list(zip(cams, rgba))
    write_dnerf_scene(str(root), {"train": frames[:-n_test],
                                  "test": frames[-n_test:]}, name=name)
    return str(root)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return dnerf_fixture(tmp_path_factory.mktemp("dnerf"))


def _same_samples(ts, js):
    assert len(ts) == len(js) > 0
    for t, j in zip(ts, js):
        for f in ("w2c", "cam_center", "fx", "fy", "time"):
            np.testing.assert_array_equal(getattr(t.camera, f).numpy(),
                                          np.asarray(getattr(j.camera, f)),
                                          err_msg=f)
        assert (t.camera.H, t.camera.W) == (j.camera.H, j.camera.W)
        np.testing.assert_array_equal(t.image, j.image)
        np.testing.assert_array_equal(t.alpha, j.alpha)
        assert t.image_name == j.image_name
        bg = np.array([0.2, 0.5, 1.0], np.float32)
        np.testing.assert_array_equal(t.gt(bg), j.gt(bg))


@pytest.mark.parametrize("eval_split", [True, False])
def test_load_scene_matches_jax(scene_dir, eval_split):
    kw = dict(eval_split=eval_split, num_init_points=5000, seed=7)
    j = jdnerf.load_scene(scene_dir, **kw)
    t = tdnerf.load_scene(scene_dir, device="cpu", **kw)
    _same_samples(t.train_cameras, j.train_cameras)
    _same_samples(t.test_cameras, j.test_cameras)
    assert len(t.train_cameras) == (9 if eval_split else 12)
    np.testing.assert_array_equal(t.nerf_norm["translate"],
                                  j.nerf_norm["translate"])
    assert t.nerf_norm["radius"] == j.nerf_norm["radius"]
    assert t.cameras_extent == j.cameras_extent
    np.testing.assert_array_equal(t.init_points, j.init_points)
    np.testing.assert_array_equal(t.init_colors, j.init_colors)
    assert t.init_points.dtype == np.float32


def test_dynamic360_layout_matches_jax(scene_dir, tmp_path):
    """A single transforms.json (Dynamic-360), sniffed after the others."""
    root = tmp_path / "d360"
    root.mkdir()
    os.symlink(os.path.join(scene_dir, "train"), root / "train")
    with open(os.path.join(scene_dir, "transforms_train.json")) as fh:
        (root / "transforms.json").write_text(fh.read())
    j = jdnerf.load_scene(str(root), num_init_points=100)
    t = tdnerf.load_scene(str(root), device="cpu", num_init_points=100)
    _same_samples(t.train_cameras, j.train_cameras)
    assert t.test_cameras == [] == j.test_cameras
    np.testing.assert_array_equal(t.init_points, j.init_points)


@pytest.mark.parametrize("sentinel", ["sparse", "cameras_sphere.npz",
                                      "dataset.json", "poses_bounds.npy",
                                      "train_meta.json"])
def test_unported_layouts_raise(tmp_path, sentinel):
    """Each sentinel routes to its reader in both packages (those readers
    are ported now: tests/test_torch_readers.py): an empty sentinel file
    raises the same exception type in both, and never
    NotImplementedError."""
    (tmp_path / sentinel).write_text("")
    with pytest.raises(Exception) as j:
        jdnerf.load_scene(str(tmp_path))
    with pytest.raises(Exception) as t:
        tdnerf.load_scene(str(tmp_path), device="cpu")
    assert type(t.value) is type(j.value)
    assert not isinstance(t.value, NotImplementedError)


def test_unknown_layout_raises(tmp_path):
    with pytest.raises(ValueError, match="unrecognised"):
        tdnerf.load_scene(str(tmp_path), device="cpu")


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

CFG = dict(sh_degree=1, hyper_dim=2, node_num=8, gaussian_capacity=64,
           node_gauss_capacity=32)


def _points(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(32, 3).astype(np.float32),
            rs.rand(32, 3).astype(np.float32))


def _random_jax_state():
    """A JAX TrainState whose every leaf is random (bools, counts and the
    key too), so a cross-load that mixes two leaves up shows."""
    state = jtrainer.init_train_state(jax.random.PRNGKey(0),
                                      JTrainConfig(**CFG), *_points())
    rs = np.random.RandomState(1)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    new = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if a.dtype == bool:
            a = rs.rand(*a.shape) > 0.3
        elif a.dtype.kind in "iu":
            a = rs.randint(0, 3 if a.ndim == 0 else 1000,
                           size=a.shape).astype(a.dtype)
        else:
            a = rs.randn(*a.shape).astype(a.dtype)
        new.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, new)


def _jax_leaves(state):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}


def _port_template():
    return ttrainer.init_train_state(TrainConfig(**CFG), *_points(5),
                                     device="cpu")


def _port_leaves(state):
    out = {k: t.detach().numpy() for k, t in
           tckpt.tensor_leaves(state).items()}
    for part in ("gauss", "ngauss"):
        out[f".{part}.active_sh_degree"] = np.asarray(
            getattr(state, part).active_sh_degree, np.int32)
    return out


def test_checkpoint_keys_match_jax(tmp_path):
    js = _random_jax_state()
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_train_state(jpath, js, 3, 4)
    tckpt.save_train_state(tpath, _port_template(), 3, 4)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        kj, kt = set(zj.files), set(zt.files)
        assert kt - kj == {tckpt.GENERATOR}
        assert kj == kt - {tckpt.GENERATOR}
        for k in kj:
            assert zt[k].shape == zj[k].shape, k
            assert zt[k].dtype == zj[k].dtype, k


def test_jax_checkpoint_loads_in_port(tmp_path):
    js = _random_jax_state()
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_train_state(path, js, iteration=123, iteration_node=45)
    ts, it, it_node = tckpt.load_train_state(path, _port_template())
    assert (it, it_node) == (123, 45)
    jl, tl = _jax_leaves(js), _port_leaves(ts)
    assert set(tl) == set(jl) - {".key"}
    for k in tl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    # the generator is seeded from the JAX key's words
    key = np.asarray(js.key).astype("<u4").tobytes()
    assert ts.generator.initial_seed() == \
        int.from_bytes(key, "little") % (1 << 63)


def test_port_checkpoint_loads_in_jax(tmp_path):
    ts, _, _ = tckpt.load_train_state(_write_jax_random(tmp_path),
                                      _port_template())
    ts.gauss.active_sh_degree = 1
    path = str(tmp_path / "port.npz")
    tckpt.save_train_state(path, ts, iteration=7, iteration_node=9)
    template = jtrainer.init_train_state(jax.random.PRNGKey(3),
                                         JTrainConfig(**CFG), *_points(9))
    js, it, it_node = jckpt.load_train_state(path, template)
    assert (it, it_node) == (7, 9)
    jl, tl = _jax_leaves(js), _port_leaves(ts)
    for k in tl:
        np.testing.assert_array_equal(jl[k], tl[k], err_msg=k)
        assert jl[k].dtype == tl[k].dtype, k
    seed = ts.generator.initial_seed()
    np.testing.assert_array_equal(
        jl[".key"], np.asarray([seed & 0xFFFFFFFF, seed >> 32], np.uint32))


def _write_jax_random(tmp_path):
    path = str(tmp_path / "jax.npz")
    jckpt.save_train_state(path, _random_jax_state())
    return path


def test_port_checkpoint_roundtrip_is_bitwise(tmp_path):
    """Written, read back into a fresh template and written again: the
    same arrays, the generator's stream included."""
    ts, _, _ = tckpt.load_train_state(_write_jax_random(tmp_path),
                                      _port_template())
    torch.rand(5, generator=ts.generator)       # move the stream
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    tckpt.save_train_state(a, ts, 11, 12)
    ts2, it, it_node = tckpt.load_train_state(a, _port_template())
    assert (it, it_node) == (11, 12)
    tckpt.save_train_state(b, ts2, it, it_node)
    with np.load(a) as za, np.load(b) as zb:
        assert za.files == zb.files
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    assert torch.equal(torch.rand(5, generator=ts.generator),
                       torch.rand(5, generator=ts2.generator))


def test_checkpoint_load_refuses_other_layouts(tmp_path):
    path = _write_jax_random(tmp_path)
    bigger = ttrainer.init_train_state(
        TrainConfig(**dict(CFG, gaussian_capacity=128)), *_points(),
        device="cpu")
    with pytest.raises(ValueError, match="config mismatch"):
        tckpt.load_train_state(path, bigger)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "leaf:.gauss.xyz"}
    np.savez(str(tmp_path / "cut.npz"), **arrays)
    with pytest.raises(KeyError, match="gauss.xyz"):
        tckpt.load_train_state(str(tmp_path / "cut.npz"), _port_template())


# ----------------------------------------------------------------------
# PLY
# ----------------------------------------------------------------------

@pytest.mark.parametrize("sh,fea,motion", [(2, 3, True), (1, 0, False)])
def test_ply_bytes_match_jax(tmp_path, sh, fea, motion):
    import dataclasses

    from d2dgs_tpu.models.gaussians import create_from_pcd
    rs = np.random.RandomState(sh)
    p = create_from_pcd(rs.randn(17, 3).astype(np.float32),
                        rs.rand(17, 3).astype(np.float32), 32,
                        sh_degree=sh, fea_dim=fea, with_motion_mask=motion)
    p = dataclasses.replace(p, **{
        f: jnp.asarray(rs.randn(*getattr(p, f).shape), jnp.float32)
        for f in ("features_rest", "rotation", "opacity", "feature",
                  "scaling")})
    t = lambda f: torch.from_numpy(np.array(getattr(p, f)))
    tp = GaussianParams(**{f: t(f) for f in GAUSS_FIELDS}, alive=t("alive"),
                        active_sh_degree=sh, with_motion_mask=motion)
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jply.save_gaussian_ply(jpath, p)
    tply.save_gaussian_ply(tpath, tp)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()

    kw = dict(capacity=40, sh_degree=sh, fea_dim=fea, with_motion_mask=motion)
    jq = jply.load_gaussian_ply(tpath, **kw)
    tq = tply.load_gaussian_ply(jpath, device="cpu", **kw)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "feature", "alive"):
        np.testing.assert_array_equal(getattr(tq, f).detach().numpy(),
                                      np.asarray(getattr(jq, f)), err_msg=f)
    assert tq.active_sh_degree == int(jq.active_sh_degree) == sh
