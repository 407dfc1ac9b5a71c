"""SIBR remote-viewer wire protocol (TCP): the counterpart of
``gsjax.viewer.network_gui``.

Byte-compatible with the reference's viewer bridge (reference:
gaussian_renderer/network_gui.py:24-86), so the stock
``SIBR_remoteGaussian_app`` can watch a training run of the port:

* request: 4-byte little-endian length + JSON with resolution, train toggle,
  fovs, near/far, python-path toggles, keep_alive, scaling_modifier and the
  transposed view / view-projection matrices with the Y/Z column sign flips
  (network_gui.py:75-78);
* reply: raw HWC uint8 RGB bytes, then a 4-byte LE length-prefixed
  source-path string.

The incoming matrices use the reference's row-vector convention; they are
flipped and transposed into the port's column-vector ``RenderCamera``, on
the device of the state being rendered.
"""

from __future__ import annotations

import json
import socket
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from gsjax_torch.data.cameras import RenderCamera
from gsjax_torch.train.step import quantize


def _camera_from_message(msg, device="cuda") -> Optional[RenderCamera]:
    width, height = msg["resolution_x"], msg["resolution_y"]
    if width == 0 or height == 0:
        return None
    wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
    wv[:, 1] *= -1
    wv[:, 2] *= -1
    fp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    fp[:, 1] *= -1
    world_view = wv.T  # row-vector convention -> column-vector
    full_proj = fp.T
    cam_center = np.linalg.inv(world_view)[:3, 3]

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return RenderCamera(
        world_view=t(world_view),
        full_proj=t(full_proj),
        camera_center=t(cam_center),
        tan_fov_x=t(np.tan(msg["fov_x"] / 2)),
        tan_fov_y=t(np.tan(msg["fov_y"] / 2)),
        width=int(width),
        height=int(height),
    )


class ViewerBridge:
    """Non-blocking listener polled once per training iteration
    (reference: train.py:52-66)."""

    def __init__(self, host="127.0.0.1", port=6009, source_path="",
                 max_iterations=30_000):
        self.source_path = source_path
        self.max_iterations = max_iterations
        self.conn: Optional[socket.socket] = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind((host, port))
            self.listener.listen()
        except OSError:
            self.listener.close()
            raise
        self.listener.settimeout(0)

    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nViewer connected by {addr}")
            self.conn.settimeout(None)
        except OSError:
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed connection")
            buf += chunk
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def send(self, image_bytes: Optional[bytes]):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        verify = self.source_path
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(
        self, device="cuda",
    ) -> Tuple[Optional[RenderCamera], bool, bool, bool, bool, float]:
        """Returns (camera on ``device``, do_training, shs_python,
        rot_scale_python, keep_alive, scaling_modifier) — the reference's
        tuple shape (network_gui.py:57-84)."""
        msg = self.read()
        cam = _camera_from_message(msg, device)
        if cam is None:
            return None, False, False, False, False, 1.0
        return (
            cam,
            bool(msg["train"]),
            bool(msg.get("shs_python", False)),
            bool(msg.get("rot_scale_python", False)),
            bool(msg["keep_alive"]),
            float(msg["scaling_modifier"]),
        )

    def poll(self, iteration, state, render_fn):
        """Serve viewer requests; blocks while the viewer pauses training.
        Any protocol error drops the connection and training continues
        (reference: train.py:64-65). The wire message's scaling_modifier
        and shs/rot_scale python-path toggles are applied to the live
        render exactly as the reference does (train.py:57-60)."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                (cam, do_training, shs_python, rot_scale_python, keep_alive,
                 scaling_modifier) = self.receive(state.device)
                image_bytes = None
                if cam is not None:
                    img = render_fn(
                        state, cam, torch.zeros(3, device=state.device),
                        scaling_modifier,
                        shs_python=shs_python,
                        cov3d_python=rot_scale_python,
                    )
                    if img.dtype != torch.uint8:  # as_uint8 fns already did it
                        img = quantize(img)
                    image_bytes = memoryview(img.contiguous().cpu().numpy())
                self.send(image_bytes)
                if do_training and (
                    iteration < self.max_iterations or not keep_alive
                ):
                    break
            except Exception as e:  # noqa: BLE001 — the reference drops the viewer, trains on
                print(f"viewer connection dropped: {e!r}", file=sys.stderr)
                self.conn.close()
                self.conn = None

    def close(self):
        if self.conn is not None:
            self.conn.close()
        self.listener.close()
