"""cnc_torch's file datasets against cnc_tpu's, on small datasets written by
tools/make_sphere_blender.py (Blender layout) and tools/make_tanks_nsvf.py
(NSVF layout) into a tmp dir: each image's rays and pixels (and trainval's),
the scene box, the white and black backgrounds, the random background drawn
from the trainer's generator, and every fetched ray a row of its image's
rays with its pixel."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from cnc_tpu.data import nerf_synthetic as jnerf
from cnc_tpu.data import tanks as jtanks
from cnc_torch.data import nerf_synthetic as tnerf
from cnc_torch.data import tanks as ttanks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("blender"))
    argv = sys.argv
    sys.argv = ["make_sphere_blender.py", root, "3", "24"]   # 3 train views of 24x24
    try:
        _tool("make_sphere_blender").main()
    finally:
        sys.argv = argv
    return root


@pytest.fixture(scope="module")
def tanks_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tanks"))
    mod = _tool("make_tanks_nsvf")
    mod.W, mod.H = 40, 24                 # the layout and conventions, at 40x24
    mod.make_dataset(root, n_train=3, n_test=2)
    return root


def _loaders(kind, root, split, **kw):
    if kind == "blender":
        return (jnerf.SubjectLoader("spheres", root, split, **kw),
                tnerf.SubjectLoader("spheres", root, split, device="cpu", **kw))
    return (jtanks.SubjectLoaderTanks("Spheres", root, split, **kw),
            ttanks.SubjectLoaderTanks("Spheres", root, split, device="cpu", **kw))


def _assert_image_rays_equal(j, t):
    assert len(j) == len(t) and (j.WIDTH, j.HEIGHT) == (t.WIDTH, t.HEIGHT)
    np.testing.assert_array_equal(t.K.numpy(), np.asarray(j.K))
    for i in range(len(j)):
        (jr, jp), (tr, tp) = j.image_and_rays(i), t.image_and_rays(i)
        np.testing.assert_allclose(tr.origins.numpy(), np.asarray(jr.origins), atol=1e-6)
        np.testing.assert_allclose(tr.viewdirs.numpy(), np.asarray(jr.viewdirs), atol=1e-6)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)


@pytest.mark.parametrize("kind,split", [("blender", "train"), ("blender", "test"),
                                        ("blender", "trainval"), ("tanks", "train"),
                                        ("tanks", "test"), ("tanks", "trainval")])
def test_image_rays_and_pixels_equal_cnc_tpu(blender_root, tanks_root, kind, split):
    root = blender_root if kind == "blender" else tanks_root
    j, t = _loaders(kind, root, split)
    _assert_image_rays_equal(j, t)
    want = {"blender": {"train": 3, "test": 3, "trainval": 5},
            "tanks": {"train": 3, "test": 2, "trainval": 5}}[kind][split]
    assert len(t) == want


def test_load_scene_bbox_equals_cnc_tpu(tanks_root):
    ja, js = jtanks.load_scene_bbox(tanks_root, "Spheres")
    ta, ts = ttanks.load_scene_bbox(tanks_root, "Spheres")
    np.testing.assert_array_equal(ta, ja)
    assert ts == js == 4e-3 and ta.dtype == ja.dtype
    t = ttanks.SubjectLoaderTanks("Spheres", tanks_root, "test", device="cpu")
    np.testing.assert_array_equal(t.aabb, ja)
    assert t.render_step_size == js


@pytest.mark.parametrize("bkgd", ["white", "black"])
def test_backgrounds_match_cnc_tpu(blender_root, bkgd):
    j, t = _loaders("blender", blender_root, "test", color_bkgd_aug=bkgd)
    _assert_image_rays_equal(j, t)
    alpha = t.alphas[0, ..., 0].numpy()
    assert (alpha == 0).any()
    np.testing.assert_array_equal(t.image_and_rays(0)[1].numpy()[alpha == 0],
                                  1.0 if bkgd == "white" else 0.0)


@pytest.mark.parametrize("kind,bkgd", [("blender", "white"), ("blender", "random"),
                                       ("tanks", "white")])
def test_fetched_rays_are_rows_of_their_images(blender_root, tanks_root, kind, bkgd):
    """Every ray fetch_rays returns equals one pixel's ray of one image, and
    its pixel is that pixel over the background (a "random" one is a single
    color drawn from the trainer's generator for the batch)."""
    root = blender_root if kind == "blender" else tanks_root
    _, t = _loaders(kind, root, "train", num_rays=256, color_bkgd_aug=bkgd)
    gen = torch.Generator().manual_seed(3)
    rays, pixels = t.fetch_rays(gen, 256)
    assert rays.origins.shape == rays.viewdirs.shape == pixels.shape == (256, 3)
    everything = [t.image_and_rays(i)[0] for i in range(len(t))]
    o_all = torch.stack([r.origins for r in everything]).reshape(-1, 3)
    d_all = torch.stack([r.viewdirs for r in everything]).reshape(-1, 3)
    rgb_all = t.rgbs.reshape(-1, 3)
    a_all = t.alphas.reshape(-1, 1)
    exact = "donot_use_mm_for_euclid_dist"
    dist = (torch.cdist(rays.origins, o_all, compute_mode=exact)
            + torch.cdist(rays.viewdirs, d_all, compute_mode=exact))
    best = dist.argmin(dim=1)
    assert float(dist.gather(1, best[:, None]).max()) < 1e-5
    rgb, a = rgb_all[best], a_all[best]
    if bkgd == "random":
        # the background is one color c of the batch: pixel = rgb a + c (1 - a)
        clear = a[:, 0] < 1.0
        assert clear.sum() > 10
        c = (pixels[clear] - rgb[clear] * a[clear]) / (1.0 - a[clear])
        np.testing.assert_allclose(c.numpy(), np.broadcast_to(c[0].numpy(), c.shape), atol=1e-5)
        assert not np.allclose(c[0].numpy(), 1.0)
        gen2 = torch.Generator().manual_seed(3)
        for _ in range(3):                       # image, x, y, then the background
            torch.randint(2, (256,), generator=gen2)
        np.testing.assert_allclose(c[0].numpy(), torch.rand(3, generator=gen2).numpy(),
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(pixels.numpy(), (rgb * a + (1.0 - a)).numpy(), atol=1e-6)


def test_missing_imageio_names_it(blender_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="imageio"):
        tnerf.SubjectLoader("spheres", blender_root, "test", device="cpu")


def test_tanks_view0_drawn_in_memory_equals_the_loaders(tanks_root):
    """tools/torch_tanks_view.py's view 0 (the tanks bundle's test view,
    drawn without imageio) is what SubjectLoaderTanks reads from the files
    make_tanks_nsvf writes: rays, pixels and the scene box exactly."""
    tv = _tool("torch_tanks_view")
    rays, rgb, aabb, step = tv.view0("cpu", size=(40, 24))
    t = ttanks.SubjectLoaderTanks("Spheres", tanks_root, "test", device="cpu")
    want_rays, want_rgb = t.image_and_rays(0)
    assert torch.equal(rays.origins, want_rays.origins)
    assert torch.equal(rays.viewdirs, want_rays.viewdirs)
    assert torch.equal(rgb, want_rgb)
    np.testing.assert_array_equal(aabb, t.aabb)
    assert step == t.render_step_size
