"""D-NeRF synthetic dataset loader (Blender layout with a time per frame).

Port of `cnc_tpu/data/dnerf_synthetic.py` (the reference loader,
examples/datasets/dnerf_synthetic.py, unused by the CNC entry points):
transforms_{split}.json whose frames carry `time` (else the frame's index
over the last index), RGBA PNGs composited over white, OpenGL cameras; rays
carry their frame's timestamp for time-conditioned fields
(`models/mlp_fields.VanillaNeRF(time_input=True)`, `NDRField`).  The images
live on `device` (default cuda); `imageio` is imported only when a split is
read.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from . import cameras
from .nerf_synthetic import composite, draw_pixels, imageio_v2


def _load_split(root: str, subject: str, split: str):
    imageio = imageio_v2()
    data_dir = os.path.join(root, subject)
    with open(os.path.join(data_dir, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)
    images, poses, times = [], [], []
    for frame in meta["frames"]:
        images.append(imageio.imread(os.path.join(data_dir, frame["file_path"] + ".png")))
        poses.append(frame["transform_matrix"])
        times.append(frame.get("time", float(len(times)) / max(len(meta["frames"]) - 1, 1)))
    w = images[0].shape[1]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return (np.stack(images), np.stack(poses).astype(np.float32),
            np.asarray(times, np.float32), focal)


class SubjectLoaderDNeRF:
    OPENGL_CAMERA = True

    def __init__(self, subject_id: str, root_fp: str, split: str,
                 num_rays: Optional[int] = None, device=None):
        dev = resolve_device(device)
        images, poses, times, focal = _load_split(root_fp, subject_id, split)
        self.HEIGHT, self.WIDTH = images.shape[1:3]
        rgba = images.astype(np.float32) / 255.0
        alpha = rgba[..., 3:] if rgba.shape[-1] == 4 else np.ones_like(rgba[..., :1])
        self.rgbs = torch.from_numpy(np.ascontiguousarray(rgba[..., :3])).to(dev)
        self.alphas = torch.from_numpy(np.ascontiguousarray(alpha)).to(dev)
        self.camtoworlds = torch.from_numpy(poses).to(dev)
        self.timestamps = torch.from_numpy(times).to(dev)
        self.K = torch.tensor([[focal, 0, self.WIDTH / 2.0], [0, focal, self.HEIGHT / 2.0],
                               [0, 0, 1]], dtype=torch.float32, device=dev)
        self.num_rays = num_rays
        self.training = num_rays is not None and split in ("train", "trainval")

    def __len__(self):
        return self.rgbs.shape[0]

    def fetch_rays(self, generator: torch.Generator, num_rays: int):
        """A random (image, pixel) ray batch over white: (rays, pixels, the
        rays' timestamps)."""
        img, x, y = draw_pixels(generator, num_rays, len(self), self.WIDTH, self.HEIGHT,
                                self.rgbs.device)
        pixels = composite(self.rgbs[img, y, x], self.alphas[img, y, x], "white")
        rays = cameras.pixel_rays(self.K, self.camtoworlds[img], x, y, opengl=True)
        return rays, pixels, self.timestamps[img]

    def image_and_rays(self, index: int):
        rays = cameras.image_rays(self.K, self.camtoworlds[index], self.WIDTH, self.HEIGHT,
                                  opengl=True)
        return (rays, composite(self.rgbs[index], self.alphas[index], "white"),
                self.timestamps[index])
