"""SIBR remote-viewer protocol server (counterpart of
d2dgs_tpu/viewer/network.py).

Wire-compatible with the reference's gaussian_renderer/network_gui.py
(polled at the top of every train step, train_gui.py:216-229):

  client -> server: 4-byte little-endian length, then a JSON camera
    {resolution_x, resolution_y, train, fov_x, fov_y, z_near, z_far,
     shs_python, rot_scale_python, keep_alive, scaling_modifier,
     view_matrix (16 floats, column-major GL with flipped y/z),
     view_projection_matrix}
  server -> client: raw RGB bytes (H*W*3, uint8) followed by a 4-byte
    length-prefixed ascii string (the dataset path, used as a liveness
    echo).

The server is non-blocking: ``poll(render_fn)`` returns at once when no
client is connected.  ``render_fn(camera, scaling_modifier) -> [H,W,3]
image in [0,1]`` renders on the server's ``device``; the server undoes
the client's matrix conventions (column-major GL matrices with the y/z
columns negated).
"""
from __future__ import annotations

import json
import socket

import numpy as np
import torch


def _camera_from_message(msg, device="cuda") -> "object":
    """A Camera on ``device`` from the SIBR JSON payload."""
    from ..data.cameras import Camera
    from ..utils.general import resolve_device

    dev = resolve_device(device)
    W = int(msg["resolution_x"])
    H = int(msg["resolution_y"])
    view = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    # the client sends the torch-style transposed world2view with the y/z
    # columns negated (network_gui.py:78-80): undo both
    view[:, 1] *= -1
    view[:, 2] *= -1
    w2c = view.T  # row-major world->camera
    c2w = np.linalg.inv(w2c)
    fovx = float(msg["fov_x"])
    fovy = float(msg["fov_y"])
    fx = W / (2.0 * np.tan(fovx / 2.0))
    fy = H / (2.0 * np.tan(fovy / 2.0))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return Camera(w2c=f32(w2c), cam_center=f32(c2w[:3, 3]), fx=f32(fx),
                  fy=f32(fy), time=f32(msg.get("time", 0.0)), H=H, W=W)


class ViewerServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 echo: str = "", device="cuda"):
        self.echo = echo
        self.device = device
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.port = self.listener.getsockname()[1]
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: socket.socket | None = None

    def _try_accept(self):
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout, OSError):
            self.conn = None

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return buf

    def _read_message(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _send(self, image_bytes: bytes | None):
        if image_bytes:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(self.echo).to_bytes(4, "little"))
        self.conn.sendall(self.echo.encode("ascii"))

    def poll(self, render_fn) -> dict:
        """Handle at most one viewer round-trip; call once per train
        iteration.  Returns {"connected": bool, "do_training": bool,
        "keep_alive": bool} (train_gui.py:216-229: training pauses while
        a connected client sends train=False)."""
        state = {"connected": False, "do_training": True,
                 "keep_alive": True}
        if self.conn is None:
            self._try_accept()
        if self.conn is None:
            return state
        try:
            msg = self._read_message()
            state["connected"] = True
            if msg.get("resolution_x", 0) and msg.get("resolution_y", 0):
                cam = _camera_from_message(msg, self.device)
                state["do_training"] = bool(msg.get("train", True))
                state["keep_alive"] = bool(msg.get("keep_alive", True))
                with torch.no_grad():
                    img = render_fn(cam, float(msg.get("scaling_modifier",
                                                       1.0)))
                arr = np.clip(img.detach().cpu().numpy(), 0.0, 1.0)
                self._send((arr * 255).astype(np.uint8).tobytes())
            else:
                self._send(None)
        except (ConnectionError, OSError, json.JSONDecodeError):
            try:
                self.conn.close()
            finally:
                self.conn = None
        return state

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.listener.close()
