"""Mip-NeRF 360 unbounded capture loader (COLMAP layout).

Port of `cnc_tpu/data/nerf_360.py` (the reference loader,
examples/datasets/nerf_360_v2.py, unused by the CNC entry points): a small
reader of COLMAP's binary `sparse/0/{cameras,images}.bin` (no pycolmap),
every 8th image (by name) as the test split, `images_{factor}` for a
downscaled capture with K scaled by the ratio of the image width to the
camera's.  PINHOLE and SIMPLE_PINHOLE cameras map directly; for the other
models `dist_params` keeps the parameters after the third, for
`utils/camera_undistort`, and K is read as cnc_tpu reads it (fx = fy =
params[0], cx, cy = params[1:3]).  OpenCV cameras.  The images live on
`device` (default cuda); `imageio` is imported only when a split is read.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from . import cameras
from .nerf_synthetic import draw_pixels, imageio_v2

_CAM_MODELS = {0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
               2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5),
               4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8)}


def _read_cameras_bin(path: str) -> Dict[int, dict]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cam_id, model, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = _CAM_MODELS.get(model, ("UNKNOWN", 0))
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            out[cam_id] = {"model": name, "width": w, "height": h,
                           "params": np.asarray(params)}
    return out


def _read_images_bin(path: str):
    images = []
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            img_id = struct.unpack("<I", f.read(4))[0]
            qvec = struct.unpack("<4d", f.read(32))
            tvec = struct.unpack("<3d", f.read(24))
            cam_id = struct.unpack("<I", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n2d)  # the 2D points are not needed
            images.append({"id": img_id, "qvec": np.asarray(qvec), "tvec": np.asarray(tvec),
                           "camera_id": cam_id, "name": name.decode()})
    return images


def _qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y]])


class SubjectLoader360:
    """An unbounded capture; every 8th image is the test split (the
    mip-NeRF 360 protocol, as the reference loader)."""

    OPENGL_CAMERA = False

    def __init__(self, subject_id: str, root_fp: str, split: str,
                 num_rays: Optional[int] = None, factor: int = 4, device=None):
        dev = resolve_device(device)
        imageio = imageio_v2()
        data_dir = os.path.join(root_fp, subject_id)
        sparse = os.path.join(data_dir, "sparse", "0")
        cams = _read_cameras_bin(os.path.join(sparse, "cameras.bin"))
        imgs = _read_images_bin(os.path.join(sparse, "images.bin"))
        imgs.sort(key=lambda d: d["name"])
        img_dir = os.path.join(data_dir, f"images_{factor}" if factor > 1 else "images")

        sel = [i for i in range(len(imgs)) if (i % 8 == 0) == (split == "test")]
        frames, poses = [], []
        cam = cams[imgs[0]["camera_id"]]
        for i in sel:
            meta = imgs[i]
            frames.append(imageio.imread(os.path.join(img_dir, meta["name"])))
            w2c = np.eye(4)
            w2c[:3, :3] = _qvec2rotmat(meta["qvec"])
            w2c[:3, 3] = meta["tvec"]
            poses.append(np.linalg.inv(w2c))
        images = np.stack(frames)
        self.HEIGHT, self.WIDTH = images.shape[1:3]
        scale = self.WIDTH / cam["width"]
        p = cam["params"]
        if cam["model"] == "SIMPLE_PINHOLE":
            fx = fy = p[0]
            cx, cy = p[1], p[2]
            self.dist_params = None
        elif cam["model"] == "PINHOLE":
            fx, fy, cx, cy = p[:4]
            self.dist_params = None
        else:
            fx, fy, cx, cy = p[0], p[0], p[1], p[2]
            self.dist_params = torch.tensor(p[3:], dtype=torch.float32, device=dev)
        self.K = torch.tensor(np.asarray([[fx * scale, 0, cx * scale], [0, fy * scale, cy * scale],
                                          [0, 0, 1]], np.float64), dtype=torch.float32,
                              device=dev)
        rgb = images[..., :3].astype(np.float32) / 255.0
        self.rgbs = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
        self.camtoworlds = torch.from_numpy(np.stack(poses).astype(np.float32)).to(dev)
        self.num_rays = num_rays
        self.training = num_rays is not None and split in ("train", "trainval")

    def __len__(self):
        return self.rgbs.shape[0]

    def fetch_rays(self, generator: torch.Generator, num_rays: int):
        """A random (image, pixel) ray batch."""
        img, x, y = draw_pixels(generator, num_rays, len(self), self.WIDTH, self.HEIGHT,
                                self.rgbs.device)
        rays = cameras.pixel_rays(self.K, self.camtoworlds[img], x, y, opengl=False)
        return rays, self.rgbs[img, y, x]

    def image_and_rays(self, index: int):
        rays = cameras.image_rays(self.K, self.camtoworlds[index], self.WIDTH, self.HEIGHT,
                                  opengl=False)
        return rays, self.rgbs[index]
