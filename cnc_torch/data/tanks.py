"""Tanks&Temples (NSVF layout) dataset loader.

Port of `cnc_tpu/data/tanks.py` (reference SubjectLoader_Tanks,
examples/datasets/tanks.py:15-140): `rgb/{0_|1_}*.png` (train|test),
`pose/*.txt` 4x4 camera-to-world, `intrinsics.txt` 3x3 (4x4), `bbox.txt`
(aabb * 1.2 and the base step size quantized to 4e-3 / 1e-3).  OpenCV
cameras.  The images live on `device` (default cuda); `imageio` is imported
only when a split is read.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from . import cameras
from .nerf_synthetic import composite, draw_pixels, imageio_v2

SCENES = ["Barn", "Caterpillar", "Family", "Ignatius", "Truck"]
_ID_MAP = {"train": "0_", "val": "1_", "test": "1_"}


def _load_nsvf(root: str, subject: str, split: str):
    imageio = imageio_v2()
    data_dir = os.path.join(root, subject)
    rgb_files = sorted(x for x in os.listdir(os.path.join(data_dir, "rgb"))
                       if x.startswith(_ID_MAP[split]))
    pose_files = sorted(x for x in os.listdir(os.path.join(data_dir, "pose"))
                        if x.startswith(_ID_MAP[split]))
    images, poses = [], []
    for rf, pf in zip(rgb_files, pose_files):
        assert rf.split(".")[0].split("_")[-1] == pf.split(".")[0].split("_")[-1]
        images.append(imageio.imread(os.path.join(data_dir, "rgb", rf)))
        poses.append(np.loadtxt(os.path.join(data_dir, "pose", pf)))
    intrinsics = np.loadtxt(os.path.join(data_dir, "intrinsics.txt"))
    return (np.stack(images), np.stack(poses).astype(np.float32),
            intrinsics.astype(np.float32))


def load_scene_bbox(root: str, subject: str):
    """(aabb[6], render_step_size) from bbox.txt (tanks.py:135-137)."""
    raw = np.loadtxt(os.path.join(root, subject, "bbox.txt")).astype(np.float32)
    aabb = raw[:6].reshape(2, 3) * 1.2
    step = float(raw[-1])
    step = 4e-3 if step >= 0.15 else 1e-3
    return aabb.reshape(-1), step


class SubjectLoaderTanks:
    NEAR, FAR = 0.01, 6.0
    OPENGL_CAMERA = False

    def __init__(self, subject_id: str, root_fp: str, split: str,
                 num_rays: Optional[int] = None, color_bkgd_aug: str = "white", device=None):
        assert split in ("train", "val", "trainval", "test")
        dev = resolve_device(device)
        self.split = split
        self.num_rays = num_rays
        self.training = num_rays is not None and split in ("train", "trainval")
        self.color_bkgd_aug = color_bkgd_aug
        if split == "trainval":
            i1, p1, k1 = _load_nsvf(root_fp, subject_id, "train")
            i2, p2, _ = _load_nsvf(root_fp, subject_id, "val")
            images = np.concatenate([i1, i2])
            poses = np.concatenate([p1, p2])
            intr = k1
        else:
            images, poses, intr = _load_nsvf(root_fp, subject_id, split)
        self.HEIGHT, self.WIDTH = images.shape[1:3]
        img = images.astype(np.float32) / 255.0
        if img.shape[-1] == 4:
            rgb, alpha = img[..., :3], img[..., 3:]
        else:
            rgb, alpha = img, np.ones_like(img[..., :1])
        self.rgbs = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
        self.alphas = torch.from_numpy(np.ascontiguousarray(alpha)).to(dev)
        self.camtoworlds = torch.from_numpy(poses).to(dev)
        self.K = torch.from_numpy(np.ascontiguousarray(intr[:3, :3])).to(dev)
        self.aabb, self.render_step_size = load_scene_bbox(root_fp, subject_id)

    def __len__(self):
        return self.rgbs.shape[0]

    def fetch_rays(self, generator: torch.Generator, num_rays: int):
        """A random (image, pixel) ray batch over a white or black background."""
        img, x, y = draw_pixels(generator, num_rays, len(self), self.WIDTH, self.HEIGHT,
                                self.rgbs.device)
        pixels = composite(self.rgbs[img, y, x], self.alphas[img, y, x], self.color_bkgd_aug)
        rays = cameras.pixel_rays(self.K, self.camtoworlds[img], x, y, opengl=self.OPENGL_CAMERA)
        return rays, pixels

    def image_and_rays(self, index: int):
        rays = cameras.image_rays(self.K, self.camtoworlds[index], self.WIDTH, self.HEIGHT,
                                  opengl=self.OPENGL_CAMERA)
        return rays, composite(self.rgbs[index], self.alphas[index], self.color_bkgd_aug)
