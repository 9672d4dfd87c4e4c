"""NeRF-synthetic (Blender) dataset loader.

Port of `cnc_tpu/data/nerf_synthetic.py` (reference SubjectLoader,
examples/datasets/nerf_synthetic.py:53-239): transforms_{split}.json and
PNG frames, OpenGL cameras, RGBA composited over the background, random
(image, pixel) ray batches drawn from the trainer's generator.  The images
live on `device` (default cuda; raises when there is none and
`device="cpu"` was not asked for).  `imageio` is imported only when a split
is read.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from . import cameras

SCENES = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship"]


def imageio_v2():
    """imageio's v2 API, or an ImportError that names the missing package."""
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError("the file datasets read PNGs with imageio, which is not "
                          "installed") from e
    return imageio


def _load_split(root: str, subject: str, split: str):
    imageio = imageio_v2()
    data_dir = os.path.join(root, subject)
    with open(os.path.join(data_dir, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)
    images, poses = [], []
    for frame in meta["frames"]:
        fname = os.path.join(data_dir, frame["file_path"] + ".png")
        images.append(imageio.imread(fname))
        poses.append(frame["transform_matrix"])
    images = np.stack(images, 0)
    poses = np.stack(poses, 0).astype(np.float32)
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return images, poses, focal


def composite(rgb: torch.Tensor, alpha: torch.Tensor, color_bkgd_aug: str,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """RGB over the background: white, black, or (with a generator, for
    training batches) one random color drawn from it."""
    if generator is not None and color_bkgd_aug == "random":
        bkgd = torch.rand(3, generator=generator, device=generator.device).to(rgb.device)
    elif color_bkgd_aug == "black":
        bkgd = torch.zeros(3, device=rgb.device)
    else:
        bkgd = torch.ones(3, device=rgb.device)
    return rgb * alpha + bkgd * (1.0 - alpha)


def draw_pixels(generator: torch.Generator, num_rays: int, n_images: int, width: int,
                height: int, device: torch.device):
    """(image, x, y) indices of a random ray batch, drawn in that order."""
    draw = lambda high: torch.randint(high, (num_rays,), generator=generator,
                                      device=generator.device).to(device)
    return draw(n_images), draw(width), draw(height)


class SubjectLoader:
    WIDTH, HEIGHT = 800, 800
    NEAR, FAR = 2.0, 6.0
    OPENGL_CAMERA = True

    def __init__(self, subject_id: str, root_fp: str, split: str,
                 num_rays: Optional[int] = None, color_bkgd_aug: str = "white", device=None):
        assert split in ("train", "val", "trainval", "test")
        dev = resolve_device(device)
        self.split = split
        self.num_rays = num_rays
        self.training = num_rays is not None and split in ("train", "trainval")
        self.color_bkgd_aug = color_bkgd_aug
        if split == "trainval":
            i1, p1, f1 = _load_split(root_fp, subject_id, "train")
            i2, p2, _ = _load_split(root_fp, subject_id, "val")
            images = np.concatenate([i1, i2])
            poses = np.concatenate([p1, p2])
            focal = f1
        else:
            images, poses, focal = _load_split(root_fp, subject_id, split)
        self.HEIGHT, self.WIDTH = images.shape[1:3]
        rgba = images.astype(np.float32) / 255.0
        self.rgbs = torch.from_numpy(np.ascontiguousarray(rgba[..., :3])).to(dev)
        self.alphas = torch.from_numpy(np.ascontiguousarray(rgba[..., 3:])).to(dev)
        self.camtoworlds = torch.from_numpy(poses).to(dev)
        self.K = torch.tensor([[focal, 0, self.WIDTH / 2.0],
                               [0, focal, self.HEIGHT / 2.0],
                               [0, 0, 1]], dtype=torch.float32, device=dev)

    def __len__(self):
        return self.rgbs.shape[0]

    def fetch_rays(self, generator: torch.Generator, num_rays: int):
        """A random (image, pixel) ray batch; a "random" background is drawn
        from the same generator, after the pixels."""
        img, x, y = draw_pixels(generator, num_rays, len(self), self.WIDTH, self.HEIGHT,
                                self.rgbs.device)
        pixels = composite(self.rgbs[img, y, x], self.alphas[img, y, x], self.color_bkgd_aug,
                           generator if self.training else None)
        rays = cameras.pixel_rays(self.K, self.camtoworlds[img], x, y, opengl=self.OPENGL_CAMERA)
        return rays, pixels

    def image_and_rays(self, index: int):
        rays = cameras.image_rays(self.K, self.camtoworlds[index], self.WIDTH, self.HEIGHT,
                                  opengl=self.OPENGL_CAMERA)
        return rays, composite(self.rgbs[index], self.alphas[index], self.color_bkgd_aug)
