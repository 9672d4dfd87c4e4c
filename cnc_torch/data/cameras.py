"""Camera ray generation (pinhole, OpenGL or OpenCV convention).

Port of `cnc_tpu/data/cameras.py` (reference nerf_synthetic.py:199-234):
pixel centers at +0.5, y/z negated for OpenGL.  Rays land on the device of
the intrinsics `K`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Rays(NamedTuple):
    origins: torch.Tensor   # [..., 3]
    viewdirs: torch.Tensor  # [..., 3]


def pixel_rays(K: torch.Tensor, c2w: torch.Tensor, x, y, opengl: bool = True) -> Rays:
    """Rays through pixel coords (x, y).

    K: [3,3] intrinsics; c2w: [..., 3|4, 4] camera-to-world (broadcast
    against x); x, y: [...] pixel indices.
    """
    x = torch.as_tensor(x, dtype=torch.float32, device=K.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=K.device)
    sign = -1.0 if opengl else 1.0
    dirs_cam = torch.stack([
        (x - K[0, 2] + 0.5) / K[0, 0],
        (y - K[1, 2] + 0.5) / K[1, 1] * sign,
        torch.full_like(x, sign),
    ], dim=-1)
    rot = c2w[..., :3, :3]
    directions = (rot * dirs_cam[..., None, :]).sum(dim=-1)
    origins = torch.broadcast_to(c2w[..., :3, -1], directions.shape)
    viewdirs = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    return Rays(origins=origins, viewdirs=viewdirs)


def image_rays(K: torch.Tensor, c2w: torch.Tensor, width: int, height: int,
               opengl: bool = True) -> Rays:
    """All rays of one image, shape [H, W, 3]."""
    y, x = torch.meshgrid(torch.arange(height, device=K.device),
                          torch.arange(width, device=K.device), indexing="ij")
    return pixel_rays(K, c2w, x, y, opengl)


def look_at_poses(n: int, radius: float = 4.0, elevation_deg: float = 30.0,
                  target=(0.0, 0.0, 0.0), seed: int = 0,
                  full_sphere: bool = False) -> np.ndarray:
    """n camera-to-world poses on a circle/sphere looking at `target`
    (OpenGL convention: camera -z points at the target).  numpy, [n, 4, 4]."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        az = 2 * np.pi * i / n + rng.uniform(0, 0.1)
        el = (np.deg2rad(rng.uniform(-60, 60)) if full_sphere
              else np.deg2rad(elevation_deg + rng.uniform(-10, 10)))
        eye = radius * np.array([np.cos(az) * np.cos(el),
                                 np.sin(az) * np.cos(el),
                                 np.sin(el)])
        fwd = np.asarray(target) - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        new_up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = new_up
        c2w[:3, 2] = -fwd  # OpenGL: -z forward
        c2w[:3, 3] = eye
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)
