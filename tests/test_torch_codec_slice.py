"""The codec slice end to end on the CPU: a tiny port Trainer with the rate
term trains 20 steps; its binarized tables are encoded, decoded and bundled;
the decoded field renders a test view equal to the pre-codec render; a fresh
python3 process rebuilds the field from the bundle with the port's
`decode_bundle` and reproduces the tables bit for bit; and cnc_tpu's
`decode_bundle` reads the same bundle to the same tables and MLPs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cnc_tpu.train import driver as jdriver
from cnc_torch import config as tconfig
from cnc_torch.codec import codec as tcodec
from cnc_torch.data import scenes as tscenes
from cnc_torch.models import context_models as tcm
from cnc_torch.models import radiance_field as trf
from cnc_torch.train import trainer as ttrainer

from test_torch_train_rate import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores: many small
    integer ops spread over every core's thread only contend, so this
    module's ops run on one thread (restored after it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = tiny_config(tconfig)
    ds = tscenes.ProceduralDataset("sphere", n_images=3, width=24, height=24, n_steps_gt=96,
                                   device="cpu")
    entropy = tcm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d, device="cpu")
    tr = ttrainer.Trainer(cfg, ds, entropy=entropy, device="cpu")
    bits = []
    tr.fit(max_steps=19, log_every=0,
           step_callback=lambda s, aux: bits.append(float(aux["bits_per_param"])))
    before = tr.eval_image(0)[0]
    tables = trf.quantized_tables(tr.field, cfg.model)
    trained = {k: v.detach().clone() for k, v in tables.items()}
    out = str(tmp_path_factory.mktemp("bundle"))
    codec = tcodec.CNCCodec(entropy)
    cache = entropy.refresh_cache_int(tr.occ_state.binaries)
    pgs, est_mb, coded_mb = codec.encode(tr.ent_params, trained, tr.occ_state.binaries, out,
                                         cache=cache)
    rec = codec.decode(tr.ent_params, tr.occ_state.binaries, pgs, out, cache=cache)
    trf.replace_tables(tr.field, {k: torch.zeros_like(v) for k, v in rec.items()})
    trf.replace_tables(tr.field, rec)
    after = tr.eval_image(0)[0]
    tcodec.save_bundle(out, pgs, tr.ent_params, tr.field, tr.occ_state.binaries,
                       {"scene": "sphere", "lmbda": cfg.train.lmbda,
                        "n_features": cfg.model.n_features_per_level, "config": cfg.to_dict()})
    return dict(tr=tr, cfg=cfg, out=out, trained=trained, rec=rec, before=before, after=after,
                est_mb=est_mb, coded_mb=coded_mb, bits=bits, codec=codec, cache=cache)


def test_trained_20_steps_with_the_rate(run):
    assert len(run["bits"]) == 20 and np.all(np.isfinite(run["bits"]))
    assert run["coded_mb"] > 0 and np.isfinite(run["est_mb"])


def test_decode_is_lossless_on_covered_entries(run):
    """Every entry is its trained sign or, where no occupied footprint
    covers it, +1; the 2D level-0 and skipped 3D levels come back whole."""
    entropy, rec, trained = run["tr"].entropy, run["rec"], run["trained"]
    for k in rec:
        same = rec[k] == trained[k]
        assert bool((same | (rec[k] == 1)).all()), k
    for l in entropy.cfg.skip_levels_3d:
        off, size = entropy.spec3.offsets[l], entropy.spec3.level_sizes[l]
        assert torch.equal(rec["xyz"][off:off + size], trained["xyz"][off:off + size])


def test_decoded_field_renders_the_same_view(run):
    assert run["before"].shape == (24, 24, 3)
    assert torch.equal(run["after"], run["before"])


def test_bundle_decodes_in_a_fresh_process(run, tmp_path):
    """`decode_bundle` in a new python3 process (device="cpu") gives the
    in-process decode's tables and the trainer's MLPs bit for bit."""
    dump = tmp_path / "decoded.npz"
    code = ("import sys, numpy as np\n"
            "from cnc_torch.train.driver import decode_bundle\n"
            "field, binaries, cfg = decode_bundle(sys.argv[1], device='cpu', log_fn=print)\n"
            "np.savez(sys.argv[2], binaries=binaries.numpy(), "
            "**{k: v.detach().numpy() for k, v in field.state_dict().items()})\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code, run["out"], str(dump)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "decoded bundle" in res.stdout
    got = np.load(dump)
    want = {k: v.detach().numpy() for k, v in run["tr"].field.state_dict().items()}
    assert set(want) <= set(got.files)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(got["binaries"], run["tr"].occ_state.binaries.numpy())


def test_cnc_tpu_decode_bundle_reads_the_port_bundle(run):
    params, binaries, cfg = jdriver.decode_bundle(run["out"], log_fn=lambda m: None)
    as_json = lambda d: json.loads(json.dumps(d))
    assert as_json(cfg.to_dict()) == as_json(run["cfg"].to_dict())
    np.testing.assert_array_equal(np.asarray(binaries), run["tr"].occ_state.binaries.numpy())
    for k, v in run["rec"].items():
        np.testing.assert_array_equal(np.asarray(params[k]), v.numpy(), err_msg=k)
    mlp = trf.mlp_params_to_numpy(run["tr"].field)
    for name, layers in mlp.items():
        for layer, leaves in layers.items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(np.asarray(params[name][layer][leaf]), v)
    with open(os.path.join(run["out"], "meta.json")) as fh:
        assert json.load(fh)["config"] == as_json(run["cfg"].to_dict())


def test_bundle_size_counts_streams_and_meta(run):
    size = tcodec.bundle_size_mb(run["out"])
    files = [f for f in os.listdir(run["out"]) if f.endswith(".b") or f == "meta.npz"]
    assert size == sum(os.path.getsize(os.path.join(run["out"], f)) for f in files) / 2 ** 20
    assert size > run["coded_mb"]
