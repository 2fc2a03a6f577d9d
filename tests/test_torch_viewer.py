"""Port parity, the SIBR viewer (d2dgs_torch/viewer/network.py): the
round trip of tests/test_viewer_and_traj.py::test_viewer_roundtrip over
loopback (port 0) with the same message, the camera against the JAX
``_camera_from_message`` on a posed camera, and the Trainer's hook
serving one frame of its state at the top of a step."""
import json
import socket
import threading
import time

import numpy as np
import torch

from d2dgs_torch.viewer import ViewerServer
from d2dgs_torch.viewer.network import _camera_from_message
from d2dgs_tpu.viewer.network import _camera_from_message as jcamera

torch.set_num_threads(1)


def _message(w2c, W, H, train=True, **kw):
    """The SIBR client's message for a row-major world->camera matrix:
    transposed, the y/z columns negated."""
    view = np.asarray(w2c, np.float32).T.copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    msg = {"resolution_x": W, "resolution_y": H, "train": train,
           "fov_x": 0.8, "fov_y": 0.8, "z_near": 0.01, "z_far": 100.0,
           "shs_python": False, "rot_scale_python": False,
           "keep_alive": True, "scaling_modifier": 1.0,
           "view_matrix": view.reshape(-1).tolist(),
           "view_projection_matrix": np.eye(4).reshape(-1).tolist()}
    msg.update(kw)
    return msg


def _client(port, msg, n_bytes, got):
    c = socket.create_connection(("127.0.0.1", port), timeout=10)
    payload = json.dumps(msg).encode()
    c.sendall(len(payload).to_bytes(4, "little") + payload)
    img = b""
    while len(img) < n_bytes:
        img += c.recv(n_bytes - len(img))
    n = int.from_bytes(c.recv(4), "little")
    got["img"], got["echo"] = img, c.recv(n).decode()
    c.close()


def test_viewer_roundtrip():
    srv = ViewerServer(port=0, echo="scene", device="cpu")
    W = H = 8
    got, seen = {}, {}
    t = threading.Thread(target=_client, args=(
        srv.port, _message(np.eye(4), W, H), H * W * 3, got))
    t.start()

    def render_fn(cam, scaling_modifier):
        seen["cam"], seen["sm"] = cam, scaling_modifier
        return torch.full((cam.H, cam.W, 3), 0.5)

    deadline = time.time() + 20.0
    while time.time() < deadline and "img" not in got:
        srv.poll(render_fn)
        time.sleep(0.005)
    t.join(timeout=10)
    srv.close()
    assert got["echo"] == "scene"
    assert len(got["img"]) == H * W * 3
    assert got["img"][0] == 127  # 0.5 -> 127
    cam = seen["cam"]
    assert cam.H == H and cam.W == W and seen["sm"] == 1.0
    np.testing.assert_allclose(cam.w2c.numpy(), np.eye(4), atol=1e-6)


def test_camera_matches_jax():
    """A posed camera (rotation, translation, time, unequal fovs) decoded
    by both packages."""
    rs = np.random.RandomState(2)
    q, _ = np.linalg.qr(rs.normal(size=(3, 3)))
    w2c = np.eye(4)
    w2c[:3, :3] = q * np.sign(np.linalg.det(q))
    w2c[:3, 3] = rs.normal(size=3)
    msg = _message(w2c, 40, 24, fov_x=0.9, fov_y=0.6, time=0.3)
    t, j = _camera_from_message(msg, "cpu"), jcamera(msg)
    assert (t.H, t.W) == (j.H, j.W) == (24, 40)
    for f in ("w2c", "cam_center", "fx", "fy", "time"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_trainer_serves_a_frame():
    """attach_viewer, then a step: the poll at its top serves the client's
    view of the state, the bytes of the port's render of it."""
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.data.synthetic import make_video_dataset
    from d2dgs_torch.models.deform import deform_gaussians
    from d2dgs_torch.render.renderer import render
    from d2dgs_torch.train.config import TrainConfig
    from d2dgs_torch.train.trainer import Trainer
    cams, imgs, pts, cols = make_video_dataset(3, n_cams=2, n_times=2, H=16,
                                               W=16, n_gauss=16,
                                               device="cpu")
    cfg = TrainConfig(sh_degree=1, hyper_dim=2, node_num=16,
                      gaussian_capacity=256, node_gauss_capacity=128)
    tr = Trainer(cfg, cams, imgs, pts, cols, cameras_extent=4.0,
                 device="cpu")
    srv = tr.attach_viewer(port=0)
    view = orbit_camera(0.3, 0.2, 4.0, fov=0.8, H=16, W=16, device="cpu")
    msg = _message(view.w2c.numpy(), 16, 16,
                   fov_x=float(2 * np.arctan(8 / float(view.fx))),
                   fov_y=float(2 * np.arctan(8 / float(view.fy))))
    got = {}
    t = threading.Thread(target=_client, args=(srv.port, msg, 16 * 16 * 3,
                                                got))
    t.start()
    deadline = time.time() + 20.0
    while time.time() < deadline and "img" not in got:
        tr._poll_viewer()
        time.sleep(0.005)
    t.join(timeout=10)
    cam = _camera_from_message(msg, "cpu")
    g = tr.state.gauss
    with torch.no_grad():
        d = deform_gaussians(tr.state.nodes, cfg.deform_cfg, g.xyz, cam.time,
                             feature=g.feature, motion_mask=g.motion_mask)
        img = render(cam, g, torch.zeros(3), d_xyz=d["d_xyz"],
                     d_rotation=d["d_rotation"], d_scaling=d["d_scaling"],
                     cfg=cfg.raster).image
    want = (np.clip(img.numpy(), 0, 1) * 255).astype(np.uint8).tobytes()
    assert got["img"] == want and any(got["img"])
    assert tr.step()          # training goes on once the client is done
    srv.close()
