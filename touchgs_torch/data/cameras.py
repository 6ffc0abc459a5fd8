"""Pinhole camera containers (port of ``touchgs_tpu/data/cameras.py``).

World convention follows transforms.json (OpenGL c2w: +X right, +Y up, camera
looks down -Z); `Camera.w2c` converts to an OpenCV view matrix (+Z forward).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single pinhole camera: 0-dim float32 intrinsics and a (4, 4) c2w,
    all on one device."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    c2w: torch.Tensor  # (4, 4) OpenGL camera-to-world
    width: int
    height: int

    @property
    def w2c(self) -> torch.Tensor:
        """World-to-camera in OpenCV convention (+Z forward): flip the Y and
        Z columns of the rotation (diag(1, -1, -1)), then invert.  Only
        device ops, so that a step captured as a CUDA graph can take it."""
        R = torch.cat([self.c2w[:3, :1], -self.c2w[:3, 1:3]], dim=1)
        t = self.c2w[:3, 3]
        Rt = R.T
        w2c = torch.eye(4, dtype=self.c2w.dtype, device=self.c2w.device)
        w2c[:3, :3] = Rt
        w2c[:3, 3] = -(Rt @ t)
        return w2c

    @property
    def K(self) -> torch.Tensor:
        zero = torch.zeros_like(self.fx)
        one = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, zero, self.cx]),
            torch.stack([zero, self.fy, self.cy]),
            torch.stack([zero, zero, one]),
        ])


@dataclasses.dataclass
class Cameras:
    """A batch of cameras sharing one resolution (struct-of-arrays, numpy).

    `at(i, device)` materializes one `Camera` on a device.
    """

    fx: np.ndarray  # (N,)
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    c2w: np.ndarray  # (N, 4, 4)
    width: int
    height: int

    def __len__(self) -> int:
        return self.fx.shape[0]

    def at(self, i: int, device: torch.device | str = "cuda") -> Camera:
        def scalar(v):
            return torch.tensor(np.float32(v), device=device)

        return Camera(
            fx=scalar(self.fx[i]), fy=scalar(self.fy[i]),
            cx=scalar(self.cx[i]), cy=scalar(self.cy[i]),
            c2w=torch.as_tensor(np.asarray(self.c2w[i], np.float32),
                                device=device),
            width=self.width, height=self.height,
        )

    def select(self, idx: np.ndarray) -> "Cameras":
        return Cameras(
            fx=self.fx[idx], fy=self.fy[idx], cx=self.cx[idx], cy=self.cy[idx],
            c2w=self.c2w[idx], width=self.width, height=self.height,
        )

    def stacked(self, device: torch.device | str = "cuda") -> Camera:
        """All cameras as one `Camera` on ``device`` whose fields carry a
        leading batch axis: (N,) intrinsics and an (N, 4, 4) c2w, float32;
        ``width``/``height`` stay plain ints."""
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return Camera(fx=t(self.fx), fy=t(self.fy), cx=t(self.cx),
                      cy=t(self.cy), c2w=t(self.c2w), width=self.width,
                      height=self.height)

    def rescale(self, factor: float) -> "Cameras":
        """Rescale output resolution (nerfstudio `rescale_output_resolution`,
        dataparser_tactile.py:290)."""
        return Cameras(
            fx=self.fx * factor, fy=self.fy * factor,
            cx=self.cx * factor, cy=self.cy * factor,
            c2w=self.c2w,
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
        )
