"""The port's serving path as a whole: render_image against cnc_tpu's,
checkpoints written by cnc_tpu, import hygiene and device selection."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.config import ModelConfig, RenderConfig
from cnc_tpu.data import cameras as jcam
from cnc_tpu.models import radiance_field as jrf
from cnc_tpu.render import renderer as jrenderer
from cnc_tpu.utils import checkpoint as jckpt
from cnc_torch.config import ModelConfig as TModelConfig
from cnc_torch.config import RenderConfig as TRenderConfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.models import radiance_field as trf
from cnc_torch.render import renderer as trenderer
from cnc_torch.utils import checkpoint as tckpt
from cnc_torch.utils import metrics as tmetrics

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18, 34),
             resolutions_2d=(18, 34), log2_hashmap_size=10, log2_hashmap_size_2D=10,
             pe_num_freqs=4)
RKW = dict(render_step_size=0.02, occ_resolution=64, sample_budget=8192,
           eval_chunk_rays=128, eval_samples_per_iter=4)
AABB = np.asarray([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)


@pytest.fixture(scope="module")
def scene_setup():
    mcfg = ModelConfig(**SMALL)
    params = jrf.init_radiance_field(jax.random.PRNGKey(0), mcfg)
    # a dense field, so transmittance saturates and rays stop early
    params["mlp_base"]["l1"]["b"] = params["mlp_base"]["l1"]["b"].at[0].add(4.0)
    binaries = tscenes.occupancy_from_scene(tscenes.make_scene("sphere"), 64, 0.02,
                                            device="cpu").numpy()
    poses = jcam.look_at_poses(1, radius=3.0)
    K = jnp.asarray([[20.0, 0, 8.0], [0, 20.0, 8.0], [0, 0, 1]])
    rays = jcam.image_rays(K, jnp.asarray(poses[0]), 16, 16)
    o, d = np.asarray(rays.origins), np.asarray(rays.viewdirs)
    want = jrenderer.render_image(params, mcfg, dataclasses.replace(RenderConfig(), **RKW),
                                  jnp.asarray(AABB), jnp.asarray(binaries), jnp.asarray(o),
                                  jnp.asarray(d), jnp.ones(3))
    return params, binaries, o, d, [np.asarray(x) for x in want]


def _render_port(field, binaries, o, d):
    rcfg = dataclasses.replace(TRenderConfig(), **RKW)
    out = trenderer.render_image(field, TModelConfig(**SMALL), rcfg, AABB, binaries, o, d,
                                 np.ones(3, np.float32), device="cpu")
    return [x.numpy() for x in out]


def _assert_images_match(got, want):
    rgb, opacity, depth = got
    assert rgb.shape == (16, 16, 3) and opacity.shape == depth.shape == (16, 16, 1)
    np.testing.assert_allclose(rgb, want[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(opacity, want[1], atol=1e-4, rtol=0)
    opaque = want[1][..., 0] > 0.5
    assert opaque.sum() > 20
    np.testing.assert_allclose(depth[opaque], want[2][opaque], atol=1e-4, rtol=0)


def test_render_image_matches_cnc_tpu(scene_setup):
    params, binaries, o, d, want = scene_setup
    field = trf.params_from_jax(jax.tree.map(np.asarray, params), TModelConfig(**SMALL),
                                device="cpu")
    got = _render_port(field, binaries, o, d)
    _assert_images_match(got, want)
    psnr = float(tmetrics.psnr(torch.tensor(got[0]), torch.tensor(want[0])))
    assert psnr > 60.0


def test_load_field_reads_cnc_tpu_checkpoint(scene_setup, tmp_path):
    params, binaries, o, d, want = scene_setup
    payload = jckpt._flatten(params, "params")
    payload["binaries"] = np.packbits(binaries.reshape(-1))
    payload["bin_res"] = np.asarray(64)
    path = tmp_path / "ckpt.npz"
    np.savez(path, **payload)
    field, bins = tckpt.load_field(str(path), TModelConfig(**SMALL), device="cpu")
    np.testing.assert_array_equal(bins.numpy(), binaries)
    _assert_images_match(_render_port(field, bins, o, d), want)


def _port_files():
    return (sorted((ROOT / "cnc_torch").rglob("*.py")) + sorted((ROOT / "tools").glob("torch_*.py"))
            + [ROOT / "chip_smoke.py"])


def test_port_imports_neither_jax_nor_cnc_tpu():
    files = _port_files()
    assert len(files) > 15 and (ROOT / "chip_smoke.py").exists()
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "cnc_tpu", "optax"), (path, name)


def test_entry_points_raise_without_cuda_and_device(monkeypatch, scene_setup):
    params, binaries, o, d, _ = scene_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TModelConfig(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trf.RadianceField(cfg)
    field = trf.RadianceField(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trenderer.render_image(field, cfg, TRenderConfig(), AABB, binaries, o, d,
                               np.ones(3, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.load_field("unused.npz", cfg)
    from cnc_torch.data.nerf_synthetic import SubjectLoader
    from cnc_torch.data.tanks import SubjectLoaderTanks
    for loader in (SubjectLoader, SubjectLoaderTanks):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            loader("unused", "nowhere", "test")
