"""Procedural analytic scenes and their ground-truth renderer.

Port of `cnc_tpu/data/scenes.py`: an analytic density/color field rendered to
ground-truth images by a dense brute-force volume integrator, giving a
self-consistent dataset in the reference's format (images + poses +
intrinsics).  `occupancy_from_scene` is the binary grid a converged
occupancy estimator would hold (the helper cnc_tpu's tests use,
tests/test_render.py:23-30).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..utils.device import resolve_device
from . import cameras


class AnalyticScene(NamedTuple):
    sigma_fn: Callable    # [N,3] world -> [N] density
    rgb_fn: Callable      # [N,3] world -> [N,3] color in [0,1]
    aabb: Tuple[float, ...]


def _smooth_box(p, center, half, sharp=60.0):
    d = (p - p.new_tensor(center)).abs() - p.new_tensor(half)
    return torch.sigmoid(-d.amax(dim=-1) * sharp)


def _smooth_sphere(p, center, radius, sharp=60.0):
    dist = torch.linalg.vector_norm(p - p.new_tensor(center), dim=-1) - radius
    return torch.sigmoid(-dist * sharp)


def make_scene(name: str = "blocks") -> AnalyticScene:
    """A lego-ish composition of boxes and spheres ("blocks"), or one sphere."""
    if name == "blocks":
        def sigma_fn(p):
            s = (_smooth_box(p, (0.0, 0.0, -0.45), (0.7, 0.7, 0.12))      # base
                 + _smooth_box(p, (-0.25, 0.0, 0.0), (0.18, 0.45, 0.35))  # slab
                 + _smooth_sphere(p, (0.35, 0.25, 0.1), 0.28)             # ball
                 + _smooth_box(p, (0.3, -0.4, -0.05), (0.12, 0.12, 0.3))  # post
                 + _smooth_sphere(p, (-0.1, -0.35, 0.45), 0.18))
            return 80.0 * torch.clamp(s, 0.0, 1.0)

        def rgb_fn(p):
            base = 0.5 + 0.5 * torch.sin(p.new_tensor([3.1, 5.3, 7.7]) * p
                                         + p.new_tensor([0.0, 1.3, 2.1]))
            return torch.clamp(base, 0.0, 1.0)

        return AnalyticScene(sigma_fn, rgb_fn, (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5))
    if name == "sphere":
        def sigma_fn(p):
            return 100.0 * _smooth_sphere(p, (0.0, 0.0, 0.0), 0.5)

        def rgb_fn(p):
            return torch.clamp(p * 0.5 + 0.5, 0.0, 1.0)

        return AnalyticScene(sigma_fn, rgb_fn, (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5))
    raise ValueError(name)


def occupancy_from_scene(scene: AnalyticScene, res: int, dt: float, thre: float = 1e-2,
                         device=None) -> torch.Tensor:
    """[res]^3 bool grid: the analytic density at cell centers times dt above thre."""
    dev = resolve_device(device)
    g = torch.arange(res, dtype=torch.float32, device=dev)
    lo = torch.tensor(scene.aabb[:3], device=dev)
    hi = torch.tensor(scene.aabb[3:], device=dev)
    xs = (torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1) + 0.5) / res
    pts = lo + xs.reshape(-1, 3) * (hi - lo)
    return (scene.sigma_fn(pts) * dt > thre).reshape(res, res, res)


def render_gt_rays(scene: AnalyticScene, rays_o: torch.Tensor, rays_d: torch.Tensor,
                   n_steps: int = 512, bkgd=1.0):
    """Brute-force dense volume rendering of the analytic field.

    Returns (rgb [R,3] over the background, opacity [R,1]).
    """
    aabb = rays_o.new_tensor(scene.aabb)
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-10, 1e-10, rays_d)
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    tmin = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    tmax = torch.maximum(t0, t1).amin(-1)
    dt = torch.clamp(tmax - tmin, min=1e-6) / n_steps                    # [R]
    steps = torch.arange(n_steps, dtype=torch.float32, device=rays_o.device) + 0.5
    t = tmin[:, None] + steps[None, :] * dt[:, None]                      # [R, S]
    pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    flat = pos.reshape(-1, 3)
    sig = scene.sigma_fn(flat).reshape(t.shape)
    col = scene.rgb_fn(flat).reshape(t.shape + (3,))
    sdt = sig * dt[:, None]
    trans = torch.exp(-(torch.cumsum(sdt, dim=-1) - sdt))
    w = trans * (1.0 - torch.exp(-sdt))
    rgb = (w[..., None] * col).sum(dim=-2)
    opacity = w.sum(dim=-1, keepdim=True)
    return rgb + bkgd * (1.0 - opacity), opacity


class ProceduralDataset:
    """Reference-SubjectLoader-shaped dataset rendered from an analytic scene.

    Exposes images [N,H,W,3] (white background), camtoworlds [N,4,4] and K,
    on `device` (default cuda), and a random ray batcher.  Poses come from
    the same numpy seeds as cnc_tpu's, so both packages see the same views.
    """

    def __init__(self, scene_name: str = "blocks", n_images: int = 24,
                 width: int = 128, height: int = 128, split: str = "train",
                 n_steps_gt: int = 512, seed: int = 0, device=None):
        dev = resolve_device(device)
        self.scene = make_scene(scene_name)
        self.WIDTH, self.HEIGHT = width, height
        focal = 0.8 * width
        self.K = torch.tensor([[focal, 0, width / 2.0],
                               [0, focal, height / 2.0],
                               [0, 0, 1]], dtype=torch.float32, device=dev)
        seed = seed + (1000 if split == "test" else 0)
        self.camtoworlds = torch.from_numpy(cameras.look_at_poses(
            n_images, radius=3.2, seed=seed, full_sphere=True)).to(dev)
        imgs = []
        for i in range(n_images):
            rays = cameras.image_rays(self.K, self.camtoworlds[i], width, height)
            rgb, _ = render_gt_rays(self.scene, rays.origins.reshape(-1, 3),
                                    rays.viewdirs.reshape(-1, 3), n_steps_gt)
            imgs.append(rgb.reshape(height, width, 3))
        self.images = torch.stack(imgs)

    def __len__(self):
        return self.images.shape[0]

    def fetch_rays(self, generator: torch.Generator, num_rays: int):
        """Random (image, pixel) ray batch, like SubjectLoader.fetch_data."""
        dev = self.images.device
        draw = lambda high: torch.randint(high, (num_rays,), generator=generator,
                                          device=generator.device).to(dev)
        img, x, y = draw(len(self)), draw(self.WIDTH), draw(self.HEIGHT)
        pixels = self.images[img, y, x]
        rays = cameras.pixel_rays(self.K, self.camtoworlds[img], x, y)
        return rays, pixels

    def image_and_rays(self, index: int):
        rays = cameras.image_rays(self.K, self.camtoworlds[index], self.WIDTH, self.HEIGHT)
        return rays, self.images[index]
