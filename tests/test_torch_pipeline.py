"""cnc_torch's pipeline driver and CLI against cnc_tpu's: one cnc_tpu
checkpoint through both packages' `run_with_trainer` with nothing left to
train (every stream file byte-identical, the sizes equal, the PSNR and SSIM
within float noise, the TSV rows equal but for their three times), the
lambda = 0 row, a 40-step port pipeline from scratch whose bundle cnc_tpu's
`decode_bundle` reads, the CLI's `--decode_only` on that bundle, and the
CLI's flags against the repo-root drivers'.

The configuration is tests/test_pipeline.py:tiny_rd_config."""

import dataclasses
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_tpu import config as jconfig
from cnc_tpu.data import scenes as jscenes
from cnc_tpu.train import driver as jdriver
from cnc_tpu.train import trainer as jtrainer
from cnc_tpu.utils import checkpoint as jckpt
from cnc_torch import cli as tcli
from cnc_torch import config as tconfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.data.nerf_synthetic import SubjectLoader
from cnc_torch.models import context_models as tcm
from cnc_torch.models import radiance_field as trf
from cnc_torch.render import renderer as trenderer
from cnc_torch.train import driver as tdriver
from cnc_torch.train import trainer as ttrainer
from cnc_torch.utils import metrics as tmetrics

from test_torch_checkpoint import _port_dataset, _with_lmbda, tiny_rd_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME_COLS = (-5, -4, -3)      # train, encode and decode seconds
quiet = lambda *a: None


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores: this
    module's many small torch ops run on one thread (restored after it), as
    tests/test_torch_codec_slice.py's do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_ctx():
    cfg = tiny_rd_config(tconfig)
    return tcm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d, device="cpu")


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """cnc_tpu's trainer after twelve lambda = 2e-3 steps and its checkpoint;
    the test views rendered once by the port and given to both packages."""
    cfg = tiny_rd_config(jconfig)
    ds = jscenes.ProceduralDataset("sphere", n_images=4, width=32, height=32, n_steps_gt=64)
    jtr = jtrainer.Trainer(cfg, ds, entropy=jdriver.build_entropy(cfg))
    jtr.fit(max_steps=11, log_every=0)
    path = str(tmp_path_factory.mktemp("shared") / "ck.npz")
    jckpt.save_checkpoint(path, jtr)
    ttest = tscenes.ProceduralDataset("sphere", n_images=2, width=32, height=32, split="test",
                                      n_steps_gt=64, device="cpu")
    jtest = jscenes.ProceduralDataset("sphere", n_images=2, width=32, height=32, split="test",
                                      n_steps_gt=8)
    jtest.images = jnp.asarray(ttest.images.numpy())
    return dict(jtr=jtr, path=path, ttest=ttest, jtest=jtest)


def _rows(out_root, dataset_name):
    with open(os.path.join(out_root, "results", dataset_name, "output.txt")) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def _run_both(shared, port_ctx, tmp_path, lmbda):
    """Both packages' run_with_trainer from the shared checkpoint, at
    max_steps below its step: nothing trains."""
    jcfg, tcfg = (_with_lmbda(tiny_rd_config(ns), lmbda) for ns in (jconfig, tconfig))
    jtr = shared["jtr"]
    if lmbda == 0:
        jtr = jtrainer.Trainer(jcfg, None)
    jckpt.load_checkpoint(shared["path"], jtr)
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, checkpoint_path=shared["path"]))
    ttr = ttrainer.Trainer(tcfg, None, entropy=port_ctx if lmbda else None, device="cpu")
    assert ttr.step == jtr.step == 12
    out = {}
    for name, run, tr, test in (("jax", jdriver, jtr, shared["jtest"]),
                                ("port", tdriver, ttr, shared["ttest"])):
        root = str(tmp_path / name)
        res = run.run_with_trainer(tr, test, "shared", out_root=root, max_steps=0,
                                   max_eval_images=2, log_fn=quiet)
        run.append_result_row(res, "shared", "Procedural", root)
        out[name] = (res, _rows(root, "Procedural")[0], root)
    assert ttr.step == jtr.step == 12
    # the field ends holding the sweep's quantized MLPs, as cnc_tpu's
    # trainer.params does
    for k, p in trf.split_mlp_params(ttr.field).items():
        jp = jtr.params
        for s in k.split("."):
            jp = jp[s]
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp), err_msg=k)
    return out


def _assert_rows_agree(jrow, trow):
    assert len(trow) == len(jrow) == 23
    keep = [i for i in range(23) if i - 23 not in TIME_COLS]
    assert [trow[i] for i in keep] == [jrow[i] for i in keep]


def test_pipeline_from_a_shared_checkpoint_matches_cnc_tpu(shared, port_ctx, tmp_path):
    out = _run_both(shared, port_ctx, tmp_path, 2e-3)
    (jres, jrow, jroot), (tres, trow, troot) = out["jax"], out["port"]
    jdir, tdir = (os.path.join(r, "bitstreams", "shared") for r in (jroot, troot))
    streams = sorted(f for f in os.listdir(jdir) if f.endswith(".b") or f == "b_checks.json")
    assert len(streams) > 10
    assert sorted(f for f in os.listdir(tdir)
                  if f.endswith(".b") or f == "b_checks.json") == streams
    for f in streams:
        with open(os.path.join(jdir, f), "rb") as a, open(os.path.join(tdir, f), "rb") as b:
            assert a.read() == b.read(), f
    for k in ("embed_MB_est", "embed_MB_codec", "mlp_MB_orig", "context_MB", "raw_table_MB"):
        assert getattr(tres, k) == getattr(jres, k), k
    assert tres.embed_MB_codec > 0
    np.testing.assert_allclose(tres.binary_vxl_MB, jres.binary_vxl_MB, rtol=1e-6)
    assert [q["mlp_MB"] for q in tres.quant_results] == [q["mlp_MB"] for q in jres.quant_results]
    for t, j in ((tres.psnr, jres.psnr), (tres.psnr_codec, jres.psnr_codec),
                 (tres.quant_results[0]["psnr"], jres.quant_results[0]["psnr"])):
        assert abs(t - j) < 1e-3, (t, j)
    for t, j in ((tres.ssim, jres.ssim), (tres.ssim_codec, jres.ssim_codec),
                 (tres.quant_results[0]["ssim"], jres.quant_results[0]["ssim"])):
        assert abs(t - j) < 1e-4, (t, j)
    assert tres.lpips is None and tres.lpips_codec is None
    _assert_rows_agree(jrow, trow)


def test_the_lambda0_row_matches_cnc_tpu(shared, tmp_path):
    """lambda = 0: no codec (no bitstreams, zero sizes), the quantization
    sweep still runs; the rows agree but for their times."""
    out = _run_both(shared, None, tmp_path, 0.0)
    (jres, jrow, _), (tres, trow, troot) = out["jax"], out["port"]
    assert not os.path.exists(os.path.join(troot, "bitstreams"))
    assert tres.embed_MB_codec == tres.context_MB == tres.encode_s == 0.0
    assert trow[2] == trow[5] == "n/a"
    _assert_rows_agree(jrow, trow)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A 40-step port pipeline from scratch, its bundle under
    bitstreams/spheres/ for the CLI test."""
    cfg = tiny_rd_config(tconfig)
    test = tscenes.ProceduralDataset("sphere", n_images=2, width=32, height=32, split="test",
                                     n_steps_gt=64, device="cpu")
    root = str(tmp_path_factory.mktemp("port_run"))
    res = tdriver.run_pipeline(cfg, _port_dataset(), test, "spheres", out_root=root,
                               max_steps=39, max_eval_images=1, log_fn=quiet, device="cpu")
    return dict(res=res, root=root, cfg=cfg)


def test_port_pipeline_is_lossless_and_cnc_tpu_decodes_its_bundle(port_run):
    res, root = port_run["res"], port_run["root"]
    assert np.isfinite(res.psnr) and res.psnr > 5.0
    assert abs(res.psnr - res.psnr_codec) < 0.05, (res.psnr, res.psnr_codec)
    assert abs(res.embed_MB_codec - res.embed_MB_est) <= 0.15 * res.embed_MB_est
    row = tdriver.append_result_row(res, "spheres", "Procedural", root)
    assert len(row) == 23 and _rows(root, "Procedural")[-1] == row
    stream_dir = os.path.join(root, "bitstreams", "spheres")
    params, binaries, cfg = jdriver.decode_bundle(stream_dir, log_fn=quiet)
    field, tbins, tcfg = tdriver.decode_bundle(stream_dir, device="cpu", log_fn=quiet)
    assert cfg.train.lmbda == tcfg.train.lmbda == 2e-3
    np.testing.assert_array_equal(np.asarray(binaries), tbins.numpy())
    for k in trf.TABLES:
        np.testing.assert_array_equal(np.asarray(params[k]), field.tables[k].detach().numpy())
    np.testing.assert_array_equal(np.asarray(params["mlp_base"]["l0"]["w"]),
                                  field.mlp_base["l0"].w.detach().numpy())
    assert res.quant_results[0]["digits"] == 13


def test_cli_decode_only_reads_the_bundle(port_run, tmp_path, monkeypatch, capsys):
    """`--decode_only` of the CLI, on a Blender-layout test set written by
    tools/make_sphere_blender.py: the PSNR it prints is the decoded field's
    over those views."""
    data = str(tmp_path / "data")
    monkeypatch.setattr(sys, "argv", ["make_sphere_blender.py", data, "2", "32"])
    _tool("make_sphere_blender").main()
    capsys.readouterr()
    tcli.main(["nerf_synthetic", "--data_root", data, "--scene", "spheres", "--decode_only",
               "--out_root", port_run["root"], "--max_eval_images", "2", "--device", "cpu"])
    got = re.search(r"decode_only: psnr=([0-9.]+) over 2 images", capsys.readouterr().out)
    assert got is not None
    field, binaries, cfg = tdriver.decode_bundle(
        os.path.join(port_run["root"], "bitstreams", "spheres"), device="cpu", log_fn=quiet)
    test = SubjectLoader("spheres", data, "test", device="cpu")
    aabb = torch.tensor(cfg.render.aabb)
    want = []
    for i in range(2):
        rays, gt = test.image_and_rays(i)
        rgb = trenderer.render_image(field, cfg.model, cfg.render, aabb, binaries, rays.origins,
                                     rays.viewdirs, torch.ones(3), device="cpu")[0]
        want.append(float(tmetrics.psnr(rgb, gt)))
    assert abs(float(got.group(1)) - np.mean(want)) <= 5e-4


def _flags(text):
    return set(re.findall(r"(?<![\w-])--[A-Za-z_0-9]+", text))


@pytest.mark.parametrize("driver,script", [("nerf_synthetic", "train_cnc_nerf_synthetic.py"),
                                           ("tank_temples", "train_cnc_tank_temples.py")])
def test_cli_flags_are_the_root_drivers(driver, script, monkeypatch, capsys):
    """The CLI's --help lists the root driver's flags plus --device
    (--multichip: data parallel under torchrun)."""
    spec = importlib.util.spec_from_file_location(script[:-3], os.path.join(REPO, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [script, "--help"])
    with pytest.raises(SystemExit):
        mod.main()
    want = _flags(capsys.readouterr().out)
    with pytest.raises(SystemExit):
        tcli.main([driver, "--help"])
    got = _flags(capsys.readouterr().out)
    assert "--multichip" in want and "--decode_only" in want and "--help" in want
    assert got == want | {"--device"}
