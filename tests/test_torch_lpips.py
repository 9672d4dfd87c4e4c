"""cnc_torch's LPIPS (utils/lpips.py) against cnc_tpu's lpips_jax with the
synthetic weights of tests/test_lpips.py, and the evaluation that records
it: with $CNC_LPIPS_WEIGHTS pointing at a synthetic weight file, one
cnc_tpu checkpoint's `Trainer.evaluate` and `append_result_row` give the
same LPIPS in both packages; without a weight file both give None and
"n/a".

Tolerances: the distance within 1e-5 relative of lpips_jax (VGG16 in
float32, convolutions summed in another order); the evaluations' LPIPS
within 1e-4 relative (the two packages' renders differ by float noise),
their TSV columns (rounded to 4 decimals) equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_tpu import config as jconfig
from cnc_tpu.data import scenes as jscenes
from cnc_tpu.train import driver as jdriver
from cnc_tpu.train import trainer as jtrainer
from cnc_tpu.utils import checkpoint as jckpt
from cnc_tpu.utils import lpips_jax
from cnc_torch import config as tconfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.train import driver as tdriver
from cnc_torch.train import trainer as ttrainer
from cnc_torch.utils import lpips as tlpips
from cnc_torch.utils import metrics as tmetrics

from test_lpips import synth_weights
from test_torch_checkpoint import _with_lmbda, tiny_rd_config


@pytest.fixture
def weight_file(tmp_path, monkeypatch):
    path = tmp_path / "lpips_vgg16.npz"
    np.savez(path, **synth_weights())
    monkeypatch.setenv("CNC_LPIPS_WEIGHTS", str(path))
    lpips_jax.load_weights.cache_clear()
    tlpips.load_weights.cache_clear()
    yield path
    lpips_jax.load_weights.cache_clear()
    tlpips.load_weights.cache_clear()


@pytest.fixture
def no_weight_file(tmp_path, monkeypatch):
    monkeypatch.setenv("CNC_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setenv("HOME", str(tmp_path))     # no ~/.cache/cnc_tpu/lpips_vgg16.npz
    lpips_jax.load_weights.cache_clear()
    tlpips.load_weights.cache_clear()
    yield
    lpips_jax.load_weights.cache_clear()
    tlpips.load_weights.cache_clear()


@pytest.mark.parametrize("shape", [(33, 41), (64, 48)])
def test_lpips_matches_lpips_jax(shape):
    rng = np.random.default_rng(shape[0])
    a = rng.random(shape + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    w = synth_weights(1)
    want = lpips_jax.lpips(a, b, weights=w)
    got = tlpips.lpips(torch.from_numpy(a), torch.from_numpy(b), weights=w)
    assert want > 0
    assert got == pytest.approx(want, rel=1e-5)
    assert tlpips.lpips(a, a, weights=w) == pytest.approx(0.0, abs=1e-6)
    # numpy images too
    assert tlpips.lpips(a, b, weights=w) == pytest.approx(want, rel=1e-5)


def test_search_path_and_none_without_weights(weight_file, monkeypatch, tmp_path):
    w = tlpips.load_weights()
    assert w is not None and "conv12_w" in w and "lin4_w" in w
    img = np.zeros((16, 16, 3), np.float32)
    assert tmetrics.lpips_fn(img, img + 0.5) == pytest.approx(
        lpips_jax.lpips(img, img + 0.5), rel=1e-5)
    # a file lacking a layer is passed over
    bad = tmp_path / "partial.npz"
    np.savez(bad, **{k: v for k, v in synth_weights().items() if k != "lin4_w"})
    monkeypatch.setenv("CNC_LPIPS_WEIGHTS", str(bad))
    monkeypatch.setenv("HOME", str(tmp_path))
    tlpips.load_weights.cache_clear()
    assert tlpips.load_weights() is None
    assert tmetrics.lpips_fn(img, img) is None


def _trainers(tmp_path):
    """cnc_tpu's tiny lambda = 0 trainer after four steps, its checkpoint,
    and the port's trainer resumed from it; one set of test views for both."""
    jcfg = _with_lmbda(tiny_rd_config(jconfig), 0.0)
    tcfg = _with_lmbda(tiny_rd_config(tconfig), 0.0)
    ds = jscenes.ProceduralDataset("sphere", n_images=4, width=32, height=32, n_steps_gt=64)
    jtr = jtrainer.Trainer(jcfg, ds)
    jtr.fit(max_steps=3, log_every=0)
    path = str(tmp_path / "ck.npz")
    jckpt.save_checkpoint(path, jtr)
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, checkpoint_path=path))
    ttr = ttrainer.Trainer(tcfg, None, device="cpu")
    assert ttr.step == jtr.step
    ttest = tscenes.ProceduralDataset("sphere", n_images=2, width=32, height=32, split="test",
                                      n_steps_gt=64, device="cpu")
    jtest = jscenes.ProceduralDataset("sphere", n_images=2, width=32, height=32, split="test",
                                      n_steps_gt=8)
    jtest.images = jnp.asarray(ttest.images.numpy())
    return jtr, ttr, jtest, ttest


def _row(driver, ev, root):
    """The TSV row of a result holding `ev` (the other columns fixed)."""
    q = [{"digits": 13, "mlp_MB": 0.01, "psnr": ev["psnr"], "lpips": ev["lpips"],
          "ssim": ev["ssim"]}]
    res = driver.PipelineResult(
        psnr=ev["psnr"], lpips=ev["lpips"], ssim=ev["ssim"], psnr_codec=ev["psnr"],
        lpips_codec=ev["lpips"], ssim_codec=ev["ssim"], embed_MB_est=0.1, embed_MB_codec=0.1,
        mlp_MB_orig=0.02, context_MB=0.01, binary_vxl_MB=0.001, quant_results=q,
        elapsed_train_s=1.0, encode_s=0.5, decode_s=0.5, raw_table_MB=1.0)
    driver.append_result_row(res, "shared", "Procedural", str(root))
    with open(root / "results" / "Procedural" / "output.txt") as fh:
        return fh.read().rstrip("\n").split("\t")


@pytest.mark.parametrize("with_weights", [True, False], ids=["weights", "no_weights"])
def test_evaluate_and_row_report_cnc_tpus_lpips(tmp_path, request, with_weights):
    request.getfixturevalue("weight_file" if with_weights else "no_weight_file")
    jtr, ttr, jtest, ttest = _trainers(tmp_path)
    jev = jtr.evaluate(jtest, max_images=2)
    tev = ttr.evaluate(ttest, max_images=2)
    assert tev["psnr"] == pytest.approx(jev["psnr"], abs=1e-3)
    jrow = _row(jdriver, jev, tmp_path / "jax")
    trow = _row(tdriver, tev, tmp_path / "port")
    if with_weights:
        assert jev["lpips"] is not None and jev["lpips"] > 0
        assert tev["lpips"] == pytest.approx(jev["lpips"], rel=1e-4)
        assert trow[2] != "n/a"
    else:
        assert jev["lpips"] is None and tev["lpips"] is None
        assert trow[2] == trow[5] == "n/a"
    assert trow == jrow
