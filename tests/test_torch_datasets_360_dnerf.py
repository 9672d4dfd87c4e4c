"""cnc_torch's mip-NeRF 360 (COLMAP) and D-NeRF loaders against cnc_tpu's,
on small fixtures written as tests/test_datasets.py writes them: K, poses,
images, times, distortion parameters and every image's rays and pixels
(rays within 1e-6, the rest exactly); fetched batches by shape and range,
each fetched ray the row of its image's rays at the drawn pixel."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from cnc_tpu.data import dnerf_synthetic as jdnerf
from cnc_tpu.data import nerf_360 as j360
from cnc_torch.data import dnerf_synthetic as tdnerf
from cnc_torch.data import nerf_360 as t360
from cnc_torch.data.nerf_synthetic import draw_pixels
from test_datasets import H, W, _img, _poses, make_blender_fixture

OPENCV = (30.0, 33.0, W / 2 + 0.5, H / 2 - 0.5, 0.05, -0.01, 0.001, -0.002)


def make_colmap(root, scene, n, model=1, factor=1):
    """COLMAP sparse/0 binaries and images (of 1/factor the camera's width
    under images_{factor}); model 1 = PINHOLE, 4 = OPENCV."""
    import imageio.v2 as imageio
    d = os.path.join(root, scene)
    sparse = os.path.join(d, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    img_dir = os.path.join(d, f"images_{factor}" if factor > 1 else "images")
    os.makedirs(img_dir, exist_ok=True)
    params = (35.0, 35.0, W / 2, H / 2) if model == 1 else OPENCV
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, model, W * factor, H * factor))
        f.write(struct.pack(f"<{len(params)}d", *params))
    order = np.random.default_rng(n).permutation(n)      # names out of file order
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in order:
            pose = _poses(n)[i]
            w2c = np.linalg.inv(pose)
            r, t = w2c[:3, :3], w2c[:3, 3]
            qw = np.sqrt(max(np.trace(r) + 1, 1e-9)) / 2
            q = (qw, (r[2, 1] - r[1, 2]) / (4 * qw), (r[0, 2] - r[2, 0]) / (4 * qw),
                 (r[1, 0] - r[0, 1]) / (4 * qw))
            name = f"img_{i:03d}.png"
            imageio.imwrite(os.path.join(img_dir, name), _img(i, channels=3))
            f.write(struct.pack("<I", int(i) + 1))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *t))
            f.write(struct.pack("<I", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2))                  # two 2D points, skipped
            f.write(b"\x00" * 48)
    return root


def _assert_rays_equal(tr, jr):
    np.testing.assert_allclose(tr.origins.numpy(), np.asarray(jr.origins), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tr.viewdirs.numpy(), np.asarray(jr.viewdirs), atol=1e-6, rtol=0)


def _assert_fetch(loader, seed, with_times=False):
    g, g2 = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
    out = loader.fetch_rays(g, 50)
    rays, pixels = out[0], out[1]
    assert rays.origins.shape == (50, 3) and pixels.shape == (50, 3)
    assert float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0
    img, x, y = draw_pixels(g2, 50, len(loader), loader.WIDTH, loader.HEIGHT, "cpu")
    for k in range(50):
        i = int(img[k])
        image = loader.image_and_rays(i)
        r = image[0]
        np.testing.assert_allclose(rays.viewdirs[k].numpy(), r.viewdirs[y[k], x[k]].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(rays.origins[k].numpy(), r.origins[y[k], x[k]].numpy(),
                                   atol=1e-6)
        assert torch.equal(pixels[k], image[1][y[k], x[k]])
        if with_times:
            assert float(out[2][k]) == float(loader.timestamps[i])


@pytest.mark.parametrize("model,factor", [(1, 1), (4, 2)], ids=["pinhole", "opencv_factor2"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_360_loader_matches_cnc_tpu(tmp_path, model, factor, split):
    root = make_colmap(str(tmp_path), "garden", 10, model, factor)
    j = j360.SubjectLoader360("garden", root, split, factor=factor)
    t = t360.SubjectLoader360("garden", root, split, factor=factor, device="cpu")
    assert len(t) == len(j) == (2 if split == "test" else 8)    # names 0 and 8 test
    assert (t.WIDTH, t.HEIGHT) == (j.WIDTH, j.HEIGHT) == (W, H)
    np.testing.assert_array_equal(t.K.numpy(), np.asarray(j.K))
    np.testing.assert_array_equal(t.camtoworlds.numpy(), np.asarray(j.camtoworlds))
    np.testing.assert_array_equal(t.rgbs.numpy(), np.asarray(j.rgbs))
    if model == 1:
        assert t.dist_params is None and j.dist_params is None
    else:
        np.testing.assert_array_equal(t.dist_params.numpy(), np.asarray(j.dist_params))
        assert t.dist_params.shape == (5,) and float(t.K[0, 0]) == OPENCV[0] / factor
    for i in range(len(t)):
        (tr, tp), (jr, jp) = t.image_and_rays(i), j.image_and_rays(i)
        _assert_rays_equal(tr, jr)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # the test views sit at the generated eyes of images 0 and 8
    if split == "test":
        np.testing.assert_allclose(t.image_and_rays(1)[0].origins[0, 0].numpy(),
                                   _poses(10)[8][:3, 3], atol=1e-4)
    _assert_fetch(t, 3)


@pytest.mark.parametrize("with_time", [True, False], ids=["time", "index_time"])
def test_dnerf_loader_matches_cnc_tpu(tmp_path, with_time):
    root = make_blender_fixture(str(tmp_path), scene="lego", with_time=with_time)
    if with_time:       # times out of order, as D-NeRF's frames are
        path = os.path.join(root, "lego", "transforms_train.json")
        meta = json.load(open(path))
        for fr, tm in zip(meta["frames"], (0.75, 0.25, 0.5)):
            fr["time"] = tm
        json.dump(meta, open(path, "w"))
    for split in ("train", "test"):
        j = jdnerf.SubjectLoaderDNeRF("lego", root, split)
        t = tdnerf.SubjectLoaderDNeRF("lego", root, split, num_rays=16, device="cpu")
        assert len(t) == len(j) == {"train": 3, "test": 2}[split]
        assert (t.WIDTH, t.HEIGHT) == (W, H)
        np.testing.assert_array_equal(t.K.numpy(), np.asarray(j.K))
        np.testing.assert_array_equal(t.camtoworlds.numpy(), np.asarray(j.camtoworlds))
        np.testing.assert_array_equal(t.timestamps.numpy(), np.asarray(j.timestamps))
        np.testing.assert_array_equal(t.rgbs.numpy(), np.asarray(j.rgbs))
        np.testing.assert_array_equal(t.alphas.numpy(), np.asarray(j.alphas))
        for i in range(len(t)):
            (tr, tp, tt), (jr, jp, jt) = t.image_and_rays(i), j.image_and_rays(i)
            _assert_rays_equal(tr, jr)
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            assert float(tt) == float(jt)
        # white where alpha is 0
        a = t.alphas[0, ..., 0]
        assert bool((t.image_and_rays(0)[1][a == 0] == 1.0).all())
    np.testing.assert_array_equal(t.timestamps.numpy(), [0.0, 1.0])       # the test split
    want = [0.75, 0.25, 0.5] if with_time else [0.0, 0.5, 1.0]
    tr_loader = tdnerf.SubjectLoaderDNeRF("lego", root, "train", device="cpu")
    np.testing.assert_array_equal(tr_loader.timestamps.numpy(), np.asarray(want, np.float32))
    _assert_fetch(tr_loader, 4, with_times=True)
