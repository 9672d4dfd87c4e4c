"""The benchmark's scenes, cameras and training views, made from the seed.

Frozen copies, so that neither the program nor the reference supplies its
own inputs:

  * `blocks`: the analytic scene of `cnc_torch/data/scenes.py` (boxes and
    spheres over a 3-unit box), rendered to ground truth by the same dense
    volume integrator;
  * `spheres`: the four spheres of `tools/make_tanks_nsvf.py` (the repo's
    NSVF-format Spheres scene), ray-traced as hard surfaces over white, as
    that tool draws them; its density, for the occupancy grid, is a sum of
    smooth spheres.

Cameras are pinhole (`pixel_rays`, a copy of `cnc_torch/data/cameras.py`):
OpenGL poses on a sphere for `blocks`, OpenCV poses on a ring for
`spheres`, both with the field of view of the NeRF-synthetic cameras.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

CAMERA_ANGLE_X = 0.6911112070083618     # the NeRF-synthetic cameras' field of view

_SPHERES = (((0.0, 0.0, 0.0), 0.6, (0.9, 0.15, 0.1)),
            ((0.9, -0.6, 0.4), 0.35, (0.1, 0.8, 0.2)),
            ((-0.8, 0.7, -0.5), 0.45, (0.15, 0.2, 0.95)),
            ((0.2, 0.9, 0.8), 0.3, (0.9, 0.8, 0.1)))


class Rays(NamedTuple):
    origins: torch.Tensor
    viewdirs: torch.Tensor


def _smooth_box(p, center, half, sharp=60.0):
    d = (p - p.new_tensor(center)).abs() - p.new_tensor(half)
    return torch.sigmoid(-d.amax(dim=-1) * sharp)


def _smooth_sphere(p, center, radius, sharp=60.0):
    dist = torch.linalg.vector_norm(p - p.new_tensor(center), dim=-1) - radius
    return torch.sigmoid(-dist * sharp)


def sigma(scene: str, p: torch.Tensor) -> torch.Tensor:
    """Density at world points [N, 3]."""
    if scene == "blocks":
        s = (_smooth_box(p, (0.0, 0.0, -0.45), (0.7, 0.7, 0.12))
             + _smooth_box(p, (-0.25, 0.0, 0.0), (0.18, 0.45, 0.35))
             + _smooth_sphere(p, (0.35, 0.25, 0.1), 0.28)
             + _smooth_box(p, (0.3, -0.4, -0.05), (0.12, 0.12, 0.3))
             + _smooth_sphere(p, (-0.1, -0.35, 0.45), 0.18))
        return 80.0 * torch.clamp(s, 0.0, 1.0)
    if scene == "spheres":
        return 100.0 * torch.clamp(sum(_smooth_sphere(p, c, r) for c, r, _ in _SPHERES), 0, 1)
    raise ValueError(f"unknown scene {scene!r}")


def _blocks_rgb(p):
    base = 0.5 + 0.5 * torch.sin(p.new_tensor([3.1, 5.3, 7.7]) * p
                                 + p.new_tensor([0.0, 1.3, 2.1]))
    return torch.clamp(base, 0.0, 1.0)


def occupancy(scene: str, aabb, res: int, dt: float, thre: float, device):
    """(occs [res^3] float32: density times dt at the cell centres, binaries
    [res]^3 bool: occs above thre), the grid a converged occupancy estimator
    of the scene holds."""
    g = torch.arange(res, dtype=torch.float32, device=device)
    lo = torch.tensor(aabb[:3], dtype=torch.float32, device=device)
    hi = torch.tensor(aabb[3:], dtype=torch.float32, device=device)
    xs = (torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1) + 0.5) / res
    occs = sigma(scene, lo + xs.reshape(-1, 3) * (hi - lo)) * dt
    return occs, (occs > thre).reshape(res, res, res)


def intrinsics(width: int, height: int, device) -> torch.Tensor:
    focal = 0.5 * width / math.tan(0.5 * CAMERA_ANGLE_X)
    return torch.tensor([[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1]],
                        dtype=torch.float32, device=device)


def poses(scene: str, n: int, seed: int) -> np.ndarray:
    """n camera-to-world matrices [n, 4, 4] float32 drawn from the seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n + rng.uniform(0, 0.1)
        if scene == "blocks":       # OpenGL, full sphere of radius 3.2
            el = np.deg2rad(rng.uniform(-60, 60))
            eye = 3.2 * np.array([np.cos(a) * np.cos(el), np.sin(a) * np.cos(el), np.sin(el)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            cols = (right, np.cross(right, fwd), -fwd)
        else:                       # OpenCV, ring of radius 4 at heights 0.6 to 2.2
            eye = np.array([4.0 * np.cos(a), 4.0 * np.sin(a), rng.uniform(0.6, 2.2)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            cols = (right, np.cross(fwd, right), fwd)
        c2w = np.eye(4)
        for j, c in enumerate(cols):
            c2w[:3, j] = c
        c2w[:3, 3] = eye
        out.append(c2w)
    return np.stack(out).astype(np.float32)


def opengl(scene: str) -> bool:
    return scene == "blocks"


def pixel_rays(K, c2w, x, y, gl: bool) -> Rays:
    x = torch.as_tensor(x, dtype=torch.float32, device=K.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=K.device)
    sign = -1.0 if gl else 1.0
    dirs_cam = torch.stack([(x - K[0, 2] + 0.5) / K[0, 0],
                            (y - K[1, 2] + 0.5) / K[1, 1] * sign,
                            torch.full_like(x, sign)], dim=-1)
    directions = (c2w[..., :3, :3] * dirs_cam[..., None, :]).sum(dim=-1)
    origins = torch.broadcast_to(c2w[..., :3, -1], directions.shape)
    return Rays(origins, directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True))


def image_rays(K, c2w, width: int, height: int, gl: bool) -> Rays:
    y, x = torch.meshgrid(torch.arange(height, device=K.device),
                          torch.arange(width, device=K.device), indexing="ij")
    return pixel_rays(K, c2w, x, y, gl)


def _render_blocks(rays: Rays, aabb, n_steps: int = 512):
    """Dense volume rendering of `blocks` over white (render_gt_rays)."""
    o, d = rays
    box = o.new_tensor(aabb)
    inv_d = 1.0 / torch.where(d.abs() < 1e-10, 1e-10, d)
    t0, t1 = (box[:3] - o) * inv_d, (box[3:] - o) * inv_d
    tmin = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    tmax = torch.maximum(t0, t1).amin(-1)
    dt = torch.clamp(tmax - tmin, min=1e-6) / n_steps
    t = tmin[:, None] + (torch.arange(n_steps, dtype=torch.float32, device=o.device)
                         + 0.5)[None, :] * dt[:, None]
    pos = (o[:, None, :] + d[:, None, :] * t[..., None]).reshape(-1, 3)
    sdt = sigma("blocks", pos).reshape(t.shape) * dt[:, None]
    w = torch.exp(-(torch.cumsum(sdt, dim=-1) - sdt)) * (1.0 - torch.exp(-sdt))
    rgb = (w[..., None] * _blocks_rgb(pos).reshape(t.shape + (3,))).sum(dim=-2)
    return rgb + (1.0 - w.sum(dim=-1, keepdim=True))


def _trace_spheres(rays: Rays):
    """Hard spheres over white (`tools/make_tanks_nsvf.py:trace`)."""
    o, v = rays
    best = torch.full(o.shape[:1], float("inf"), device=o.device)
    rgb = torch.ones_like(o)
    for c, r, col in _SPHERES:
        oc = o - o.new_tensor(c)
        b = (oc * v).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - r * r)
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (t > 0) & (t < best)
        best = torch.where(hit, t, best)
        rgb = torch.where(hit[:, None], o.new_tensor(col), rgb)
    return rgb


class TrainViews:
    """The training images of a scene, with the random ray batcher the
    trainer calls (`fetch_rays`, as the port's datasets have it)."""

    def __init__(self, scene: str, aabb, n_images: int, width: int, height: int, seed: int,
                 device):
        self.scene, self.WIDTH, self.HEIGHT = scene, width, height
        self.gl = opengl(scene)
        self.K = intrinsics(width, height, device)
        self.camtoworlds = torch.from_numpy(poses(scene, n_images, seed)).to(device)
        imgs = []
        for i in range(n_images):
            r = image_rays(self.K, self.camtoworlds[i], width, height, self.gl)
            r = Rays(r.origins.reshape(-1, 3), r.viewdirs.reshape(-1, 3))
            rgb = (_render_blocks(r, aabb) if scene == "blocks" else _trace_spheres(r))
            imgs.append(rgb.reshape(height, width, 3))
        self.images = torch.stack(imgs)

    def __len__(self):
        return self.images.shape[0]

    def fetch_rays(self, generator: torch.Generator, num_rays: int):
        dev = self.images.device
        draw = lambda high: torch.randint(high, (num_rays,), generator=generator,
                                          device=generator.device).to(dev)
        img, x, y = draw(len(self)), draw(self.WIDTH), draw(self.HEIGHT)
        return pixel_rays(self.K, self.camtoworlds[img], x, y, self.gl), self.images[img, y, x]
