"""Port parity, the data-preparation tools (d2dgs_torch/tools/) and
``regularizers.estimate_rotation``: the cases of
tests/test_tools_and_mesh_metrics.py (colmap2nerf from a hand-written
COLMAP text model, phone_catch on synthetic 8x8 images), each run
through both packages with the outputs compared, and the rigid-motion
case of tests/test_deform.py.  Neither needs the colmap or ffmpeg
binaries."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from d2dgs_torch.models import regularizers as treg
from d2dgs_torch.tools import colmap2nerf as tc2n
from d2dgs_torch.tools import convert as tconvert
from d2dgs_torch.tools import phone_catch as tphone
from d2dgs_tpu.models import regularizers as jreg
from d2dgs_tpu.tools import colmap2nerf as jc2n
from d2dgs_tpu.tools import phone_catch as jphone

torch.set_num_threads(1)


def _colmap_scene(root):
    scene = root / "scene"
    (scene / "images").mkdir(parents=True)
    txt = scene / "colmap_text"
    txt.mkdir()
    (txt / "cameras.txt").write_text(
        "# cams\n1 OPENCV 640 480 500.0 500.0 320 240 0 0 0 0\n")
    # two cameras on the x axis looking roughly at the origin
    lines = ["# images"]
    for i, tx in enumerate([-1.0, 1.0]):
        lines.append(f"{i + 1} 1 0 0 0 {tx} 0.0 4.0 1 img_{i}.png")
        lines.append("0 0 -1")   # (points2d line, ignored)
    (txt / "images.txt").write_text("\n".join(lines) + "\n")
    return scene


def test_colmap2nerf_from_text(tmp_path):
    """transforms.json from a hand-built COLMAP text model, the same
    through both packages."""
    outs = {}
    for name, mod in (("port", tc2n), ("jax", jc2n)):
        scene = _colmap_scene(tmp_path / name)
        out = mod.colmap2nerf_invoke(str(scene / "images"),
                                     run_colmap=False)
        outs[name] = json.loads(open(out).read())
    data = outs["port"]
    assert len(data["frames"]) == 2
    assert abs(data["fl_x"] - 500.0) < 1e-6
    M = np.asarray(data["frames"][0]["transform_matrix"])
    assert M.shape == (4, 4) and np.isfinite(M).all()
    for f in data["frames"]:
        f["file_path"] = os.path.basename(f["file_path"])
    for f in outs["jax"]["frames"]:
        f["file_path"] = os.path.basename(f["file_path"])
    assert data == outs["jax"]


def _phone_scene(root):
    from PIL import Image
    imgs, msks = root / "images", root / "masks"
    imgs.mkdir(parents=True)
    msks.mkdir()
    rng = np.random.RandomState(0)
    for i in range(6):
        arr = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
        if i == 3:
            arr[:] = arr.mean()     # a blurry frame
        Image.fromarray(arr).save(imgs / f"{i:05d}.png")
        Image.fromarray((np.ones((8, 8)) * 255).astype(np.uint8)).save(
            msks / f"{i:05d}.png")
    return str(imgs), str(msks)


def test_phone_catch_mask_and_blur(tmp_path):
    from PIL import Image
    res = {}
    for name, mod in (("port", tphone), ("jax", jphone)):
        imgs, msks = _phone_scene(tmp_path / name)
        amb, scores = mod.select_ambiguity(imgs, nb=4, threshold=0.5)
        out = mod.mask_images(imgs, msks)
        mod.rename_images(out)
        files = sorted(os.listdir(out))
        res[name] = ([os.path.basename(a) for a in amb], scores, files,
                     [np.asarray(Image.open(os.path.join(out, f)))
                      for f in files])
    amb, scores, files, arrays = res["port"]
    assert any("00003" in a for a in amb)
    assert len(files) == 6 and files[0] == "00000.png"
    assert arrays[0].shape[-1] == 4
    assert amb == res["jax"][0] and files == res["jax"][2]
    np.testing.assert_array_equal(np.asarray(scores, np.float64),
                                  np.asarray(res["jax"][1], np.float64))
    for a, b in zip(arrays, res["jax"][3]):
        np.testing.assert_array_equal(a, b)


def test_convert_resize_pyramid(tmp_path):
    """The PIL pyramid of ``convert --resize`` (the part that needs no
    colmap): images_2/_4/_8 at the floor-divided sizes."""
    from PIL import Image
    src = tmp_path / "images"
    src.mkdir()
    Image.fromarray((np.random.RandomState(1).rand(16, 24, 3) * 255)
                    .astype(np.uint8)).save(src / "a.png")
    tconvert._resize_images(str(tmp_path))
    for div in (2, 4, 8):
        im = Image.open(tmp_path / f"images_{div}" / "a.png")
        assert im.size == (24 // div, 16 // div)


def _rigid_case():
    """tests/test_deform.py's rigid case: 30 points, a rotation about z and
    a shift, the JAX package's K=8 graph, and a noisy target."""
    src = np.random.RandomState(3).normal(size=(30, 3)).astype(np.float32)
    theta = 0.7
    Rz = np.array([[np.cos(theta), -np.sin(theta), 0],
                   [np.sin(theta), np.cos(theta), 0], [0, 0, 1.0]],
                  np.float32)
    tgt = (src @ Rz.T + np.array([1.0, -2.0, 0.5], np.float32)).astype(
        np.float32)
    nn_idx, w, _ = jreg.connectivity_from_points(jnp.asarray(src), K=8)
    tgt2 = tgt + np.random.RandomState(4).normal(
        size=tgt.shape).astype(np.float32) * 0.05
    return src, Rz, tgt, tgt2, nn_idx, w


def _assert_per_vertex(R, R_ref, tol, what):
    err = np.abs(R - R_ref).max(axis=(1, 2))
    worst = int(np.argmax(err / tol))
    assert (err <= tol).all(), (
        f"{what}: vertex {worst} off by {err[worst]:.3g}, bound "
        f"{tol[worst]:.3g}")


def test_estimate_rotation_recovers_rigid():
    """tests/test_deform.py's rigid case, and both packages' rotations
    against a float64 oracle (numpy's SVD of the float64 S, the same det
    fix) on the same graph, vertex by vertex.

    Each vertex is held to regularizers.rotation_rounding_bound(S, c):
    max(1e-5, c eps s1 / (s2 + s3)) (s2 - s3 where the det fix flips),
    how far float32 may move a polar factor.  Vertex 29's neighbourhood
    is almost a line (s = 1.80, 2.40e-3, 2.85e-4), so its rotation has
    room 8.0e-5 per unit of c; LAPACK builds put the port 1.16e-5 and
    JAX 1.11e-6 from the oracle there, 1.28e-5 apart, and a flat 1e-5
    passed or failed with the host.  Every other vertex's bound is the
    1e-5 floor, as before.  c = regularizers.ROTATION_ROUNDING_C = 4: the
    worst measured |R - R64| / (eps s1 / d) over the 60 vertices of the
    two cases is 2.62 (the port; JAX 1.68, the packages' difference
    2 x 1.30), so every vertex would hold even without the floor.  The
    packages are held to each other at the bound of 2c (the triangle
    inequality), with the same 1e-5 floor."""
    src, Rz, tgt, tgt2, nn_idx, w = _rigid_case()
    nn_t = torch.tensor(np.asarray(nn_idx)).long()
    w_t = torch.tensor(np.asarray(w))
    c = treg.ROTATION_ROUNDING_C
    assert c <= 8
    Rhat = treg.estimate_rotation(torch.tensor(src), torch.tensor(tgt),
                                  nn_t, w_t)
    np.testing.assert_allclose(Rhat.numpy(), np.tile(Rz, (30, 1, 1)),
                               atol=1e-4)
    # the rigid target through eager JAX, the noisy one through jit
    for label, target, jfn in (
            ("rigid", tgt, jreg.estimate_rotation),
            ("noisy", tgt2, jax.jit(jreg.estimate_rotation))):
        tR = treg.estimate_rotation(torch.tensor(src), torch.tensor(target),
                                    nn_t, w_t).numpy()
        jR = np.asarray(jfn(jnp.asarray(src), jnp.asarray(target), nn_idx,
                            w))
        S = treg.procrustes_covariance64(src, target, nn_t, w_t)
        R64 = treg.rotation_oracle(S)
        tol = treg.rotation_rounding_bound(S, c)
        _assert_per_vertex(tR, R64, tol, f"{label}: port vs float64")
        _assert_per_vertex(jR, R64, tol, f"{label}: JAX vs float64")
        _assert_per_vertex(tR, jR, treg.rotation_rounding_bound(S, 2 * c),
                           f"{label}: port vs JAX")
    e = treg.arap_energy(torch.stack([torch.tensor(src), torch.tensor(tgt)]),
                         nn_t, w_t)
    assert float(e) < 1e-8


def test_rotation_rounding_bound():
    """The bound at vertex 29 of the rigid case (s = 1.80, 2.40e-3,
    2.85e-4): 2 eps 1.80 / 2.69e-3 = 1.6e-4 at c = 2; a well-conditioned
    vertex is clamped to the 1e-5 floor; the det fix's flip takes
    s2 - s3; a rank-1 S leaves the rotation undetermined; and the oracle
    gives a proper rotation either way."""
    src, Rz, tgt, _, nn_idx, w = _rigid_case()
    S = treg.procrustes_covariance64(src, tgt, np.asarray(nn_idx),
                                     np.asarray(w))
    sig = np.linalg.svd(S, compute_uv=False)
    np.testing.assert_allclose(sig[29], [1.80, 2.40e-3, 2.85e-4], rtol=2e-2)
    tol = treg.rotation_rounding_bound(S, c=2.0)
    expect = 2 * 2.0 ** -23 * sig[29, 0] / (sig[29, 1] + sig[29, 2])
    np.testing.assert_allclose(tol[29], expect, rtol=1e-12)
    assert 1.5e-4 < tol[29] < 1.7e-4
    well = int(np.argmin(sig[:, 0] / (sig[:, 1] + sig[:, 2])))
    assert tol[well] == 1e-5
    np.testing.assert_allclose(treg.rotation_oracle(S),
                               np.tile(Rz, (30, 1, 1)), atol=1e-4)
    # a reflected S: the det fix flips, and d is s2 - s3
    refl = np.diag([3.0, 2.0, -1.0])[None]
    np.testing.assert_allclose(np.linalg.det(treg.rotation_oracle(refl)),
                               1.0)
    np.testing.assert_allclose(treg.rotation_rounding_bound(refl, c=1e6),
                               1e6 * 2.0 ** -23 * 3.0 / (2.0 - 1.0))
    assert np.isinf(treg.rotation_rounding_bound(
        np.diag([1.0, 0.0, 0.0])[None])[0])
