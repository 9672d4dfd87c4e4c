"""cnc_torch's data-parallel path (parallel/sharding.py, Trainer(group=),
the row-sharded frac plane) against cnc_tpu's mesh path and against the
port's own one-process yardstick, `dp_step_plain`.

The port's ranks run as spawned processes (tests/test_torch_parallel_ranks.py) in a gloo
group over a file:// rendezvous in tmp_path, one thread each, a group
timeout of 60 s, joined with a deadline (`sharding.run_ranks`); cnc_tpu runs
on conftest's 8 CPU devices through its own `shard_map` (`make_mesh(W)`,
`Trainer(mesh=)`).  Inputs come from numpy seeds.

Stated tolerances.  The frac plane: equal, not close (integer counts).
Render step: mse 1e-6 relative, the sample counts equal, gradients 1e-5 of
each parameter's largest entry.  Rate step: bits 1e-5 relative, gradients
1e-5 of each parameter's largest entry.  The collective step against
`dp_step_plain` (float sums in another order): the same.
"""

import dataclasses
import os
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cnc_tpu import config as jconfig
from cnc_tpu.parallel import sharding as jsharding
from cnc_tpu.train import driver as jdriver
from cnc_tpu.train import trainer as jtrainer
from cnc_torch import cli
from cnc_torch.models import radiance_field as trf
from cnc_torch.ops import context_ops as cops
from cnc_torch.parallel import sharding
from cnc_torch.train import driver as tdriver
from cnc_torch.train import trainer as ttrainer

import test_torch_parallel_ranks as dp_ranks
from pn_frac_cases import CASES, pn_case, run_walk, walk_map
from test_torch_context_tables import (KW2, KW3, asymmetric_occupancy, make_pair,
                                       random_sign_tables, starts_from_key)
from test_torch_train import _sphere_rays
from test_torch_train_rate import _param_names

RANKS_TIMEOUT_S = 240


def _run(body, world_size, tmp_path, name, inputs):
    torch.save(inputs, tmp_path / f"{name}_in.pt")
    sharding.run_ranks(body, world_size, (world_size, str(tmp_path)), RANKS_TIMEOUT_S)
    return [torch.load(tmp_path / f"{name}_out{r}.pt", weights_only=False)
            for r in range(world_size)]


def _assert_grads_close(got, want, rel=1e-5):
    """Each parameter within `rel` of its largest entry in `want`."""
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        tol = rel * np.abs(w).max()
        np.testing.assert_allclose(np.asarray(got[k], np.float64), w, rtol=0, atol=tol,
                                   err_msg=k)


def _jax_grads(jgrads):
    """cnc_tpu's gradient pytrees under the port's names (dp_ranks.grads)."""
    out = {}
    for jkey, tname in _param_names().items():
        if jkey[0] not in jgrads:
            continue
        g = jgrads[jkey[0]]
        for k in jkey[1:]:
            g = g[k]
        out[("field." if jkey[0] == "rf" else "ent.") + tname] = np.asarray(g)
    return out


# ------------------------------------------------------ the frac plane (K7p)
@pytest.mark.parametrize("name", sorted(CASES))
def test_partials_sum_to_the_whole_plane(name):
    """The plain K7p over W contiguous row chunks (chunk = ceil(rows / W)),
    summed and finished, equals the whole plane exactly, at the edge cases
    of the kernel's index math, sampled and not; each bin's divisor is the
    whole plane's."""
    for f in (2, 4):
        c = pn_case(name, f)
        args = (torch.from_numpy(c["table"]), c["fine_offset"], torch.from_numpy(c["entry_idx"]),
                torch.from_numpy(c["bounds"]), torch.tensor(c["n"], dtype=torch.int32),
                c["pn_res"])
        whole = cops.pn_frac_plane(*args, c["sample_cap"])
        rows = cops.pn_row_count(args[2], c["sample_cap"])
        for w in (1, 2, 3, 8):
            chunk = -(-rows // w)
            parts = [cops.pn_hist_part(*args, c["sample_cap"], r * chunk, chunk)
                     for r in range(w)]
            assert all(torch.equal(p[1], parts[0][1]) for p in parts)
            pos = sum(p[0] for p in parts)
            assert torch.equal(cops.pn_frac_finish(pos, parts[0][1], c["pn_res"]), whole), \
                (name, f, w)


@pytest.mark.parametrize("name", ["n1", "overflowed", "take_not_dividing", "empty_end_bins",
                                  "unsampled", "empty_bins", "masked_tail"])
def test_range_walk_visits_each_row_of_the_range_once_in_its_bin(name):
    """K7p's index math, mirrored (pn_frac_cases.run_walk with each run's
    boundaries clamped to the rank's rows, as csrc/pn_hist.cu's clamp_map
    does): the walk visits every valid row of the range exactly once, in the
    bin the whole map gives it, and no row outside the range."""
    c = pn_case(name, 2)
    bmap, take = walk_map(c["bounds"], c["n"], c["entry_idx"].shape[0], c["sample_cap"])
    bmap = np.asarray(bmap, np.int64)
    rows = cops.pn_row_count(torch.from_numpy(c["entry_idx"]), c["sample_cap"])
    bin_of = np.searchsorted(bmap, np.arange(rows), side="right") - 1
    for w in (2, 3, 8):
        chunk = -(-rows // w)
        seen = []
        for r in range(w):
            lo, hi = r * chunk, (r + 1) * chunk
            got_rows, got_bins = run_walk(c["bounds"], c["n"], c["entry_idx"].shape[0],
                                          c["sample_cap"], c["pn_res"], lo, hi)
            assert np.all((got_rows >= lo) & (got_rows < hi))
            np.testing.assert_array_equal(got_bins, bin_of[got_rows])
            seen.append(got_rows)
        seen = np.sort(np.concatenate(seen))
        valid = np.arange(rows)[(np.arange(rows) < take) & (np.arange(rows) >= bmap[0])
                                & (np.arange(rows) < bmap[-1])]
        np.testing.assert_array_equal(seen, valid)


@pytest.mark.parametrize("world_size", [2, 3, 8])
def test_sharded_plane_equals_the_whole_plane_and_cnc_tpu(world_size, tmp_path):
    """`pn_frac_plane(group=)` over W gloo ranks equals the unsharded plane
    exactly on every rank, sampled and unsampled, on the three axes of an
    asymmetric occupancy; and agrees with cnc_tpu's `pn_frac_plane(axis_name=
    "data")` under shard_map on make_mesh(W) within the frac plane's 1e-6."""
    ekw = dict(dp_ranks.EKW, pn_coords_cap=1 << 13)
    jctx, tctx = make_pair(**ekw)
    b = asymmetric_occupancy()
    jcache, tcache = jctx.refresh_cache(jnp.asarray(b)), tctx.refresh_cache(torch.from_numpy(b))
    table = random_sign_tables(tctx)["xyz"]
    cases, want, want_jax = {}, {}, {}
    mesh = jsharding.make_mesh(world_size)
    for ax in ("xy", "xz", "yz"):
        for cap in (None, 1000):
            key = f"{ax}-{cap}"
            cases[key] = (torch.from_numpy(table), tcache["pn"][ax], cap)
            want[key] = tctx.pn_frac_plane(torch.from_numpy(table), tcache["pn"][ax],
                                           sample_cap=cap)
            body = lambda t, _ax=ax, _cap=cap: jctx.pn_frac_plane(
                t, jcache["pn"][_ax], sample_cap=_cap, axis_name="data")
            want_jax[key] = np.asarray(jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False))(
                    jnp.asarray(table)))
            # XLA's CPU division is not rounded as torch's: the frac plane's
            # tolerance against cnc_tpu (tests/test_torch_pn_frac.py)
            np.testing.assert_allclose(want[key].numpy(), want_jax[key], rtol=0, atol=1e-6,
                                       err_msg=key)
    assert int(tcache["pn"]["xy"]["n"]) > 1000
    outs = _run(dp_ranks.plane_rank, world_size, tmp_path, "plane",
                {"ekw": ekw, "kw3": KW3, "kw2": KW2, "cases": cases})
    for r, out in enumerate(outs):
        for key in cases:
            assert torch.equal(out[key], want[key]), (r, key)


def test_all_reduce_sum_backward_against_a_float64_finite_difference(tmp_path):
    """The all-reduce's backward is the sum of the ranks' cotangents: two
    ranks each hold a partial p_q, plane = finish(p_0 + p_1), and rank r adds
    f_r(plane) / 2; each rank's gradient of its partial equals the central
    difference of the global loss, float64 throughout."""
    rng = np.random.default_rng(5)
    pn_res, f = 10, 2
    bins = (pn_res - 2) ** 2
    parts = [torch.from_numpy(rng.random((bins, f))) for _ in range(2)]
    den = torch.from_numpy(rng.integers(1, 9, bins).astype(np.float64) + 1e-6)
    weights = [torch.from_numpy(rng.standard_normal((pn_res * pn_res, f))) for _ in range(2)]
    outs = _run(dp_ranks.reduce_grad_rank, 2, tmp_path, "reduce",
                {"parts": parts, "den": den, "weights": weights, "pn_res": pn_res})

    def global_loss(ps):
        plane = cops.pn_frac_finish(ps[0] + ps[1], den, pn_res)
        return sum(dp_ranks.rank_objective(plane, w) for w in weights) / 2

    eps = 1e-6
    for q in range(2):
        fd = torch.zeros(bins, f, dtype=torch.float64)
        for i in range(bins):
            for k in range(f):
                up = [p.clone() for p in parts]
                dn = [p.clone() for p in parts]
                up[q][i, k] += eps
                dn[q][i, k] -= eps
                fd[i, k] = (global_loss(up) - global_loss(dn)) / (2 * eps)
        np.testing.assert_allclose(outs[q]["grad"].numpy(), fd.numpy(), rtol=1e-6, atol=1e-9)


# ------------------------------------------------------ the render step
def _load_jax_state(tr_cfg, jtr, binaries, with_ent):
    field = trf.params_from_jax(jax.tree.map(np.array, jtr.params), tr_cfg.model, device="cpu")
    state = {"field": field.state_dict(), "binaries": torch.from_numpy(binaries)}
    if with_ent:
        tctx = tdriver.build_entropy(tr_cfg, 2, device="cpu")
        state["ent"] = tctx.ent_params_from_jax(jax.tree.map(np.array, jtr.ent_params)).state_dict()
    return state


def _sphere_occupancy():
    from cnc_torch.data import scenes as tscenes
    b = tscenes.occupancy_from_scene(tscenes.make_scene("sphere"), 16, 0.02, device="cpu")
    b[:4] = False                           # asymmetric along x
    return b.numpy()


@pytest.mark.parametrize("world_size", [2, 4])
def test_render_step_matches_cnc_tpu_mesh(world_size, tmp_path):
    """One render-only step (lambda = 0) over W gloo ranks against cnc_tpu's
    `Trainer(mesh=make_mesh(W))._render_grad_fn`: the same params, occupancy
    grid and 256 rays, rank r's jitter jax.random.uniform(fold_in(key, r),
    (B / W,)).  The global mse, the summed sample counts and the reduced
    gradients (equal on every rank) agree."""
    jcfg, tcfg = dp_ranks.tiny_config(jconfig, lmbda=0.0), dp_ranks.tiny_config(lmbda=0.0)
    mesh = jsharding.make_mesh(world_size)
    jtr = jtrainer.Trainer(jcfg, dataset=None, mesh=mesh)
    binaries = _sphere_occupancy()
    o, d, pix = _sphere_rays(16, np.random.default_rng(0))
    key = jax.random.PRNGKey(9)
    m = o.shape[0] // world_size
    jitters = [torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, r), (m,))))
               for r in range(world_size)]
    g, aux = jtr._render_grad_fn(o.shape[0])(
        jtr.params, jnp.asarray(binaries), jnp.asarray(o), jnp.asarray(d), jnp.asarray(pix),
        jnp.ones(3), key)
    outs = _run(dp_ranks.step_rank, world_size, tmp_path, "step",
                {"cfg": tcfg, **_load_jax_state(tcfg, jtr, binaries, False),
                 "rays": tuple(torch.from_numpy(a) for a in (o, d, pix)), "jitters": jitters})
    taux = outs[0]["aux"]
    assert int(taux["n_marched"]) == int(aux["n_marched"]) > 500
    assert int(taux["n_samples"]) == int(aux["n_samples"]) > 100
    np.testing.assert_allclose(float(taux["mse"]), float(aux["mse"]), rtol=1e-6)
    _assert_grads_close({k: v.numpy() for k, v in outs[0]["grads"].items()}, _jax_grads({"rf": g}))
    for out in outs[1:]:
        assert all(torch.equal(out["grads"][k], outs[0]["grads"][k]) for k in outs[0]["grads"])



# ------------------------------------------------------ the rate step
def _rate_step_inputs(tcfg, jcfg, world_size):
    """cnc_tpu's mesh trainer with per-rank quotas, its gradients of one
    lambda > 0 step (render + 2D rate + 3D rate, as its `_train_step` sums
    them) and bits, and the port's inputs for the same step."""
    jctx = jdriver.build_entropy(jcfg, world_size)
    jtr = jtrainer.Trainer(jcfg, dataset=None, entropy=jctx,
                           mesh=jsharding.make_mesh(world_size))
    binaries = _sphere_occupancy()
    jtr.occ_state = jtr.occ_state._replace(binaries=jnp.asarray(binaries))
    jcache = jctx.refresh_cache(jtr.occ_state.binaries)
    o, d, pix = _sphere_rays(16, np.random.default_rng(0))
    key = jax.random.PRNGKey(9)
    m = o.shape[0] // world_size
    scale = jtr._rate_scale()
    g_rf, _ = jtr._render_grad_fn(o.shape[0])(
        jtr.params, jtr.occ_state.binaries, jnp.asarray(o), jnp.asarray(d), jnp.asarray(pix),
        jnp.ones(3), key)
    (g2, ge2), bits2d = jtr._rate2d_grad_fn()(jtr.params, jtr.ent_params, scale, key, jcache,
                                              jctx.table_arrays)
    (g3, ge3), (bits3d, _) = jtr._rate3d_grad_fn()(jtr.params, jtr.ent_params, scale, key,
                                                   jcache, jctx.table_arrays)
    jgrads = _jax_grads({"rf": jax.tree.map(lambda a, b, c: a + b + c, g_rf, g2, g3),
                         "ent": jax.tree.map(jnp.add, ge2, ge3)})
    jbits = float(bits2d + bits3d) / jctx.total_param_count
    tctx = tdriver.build_entropy(tcfg, world_size, device="cpu")
    inputs = {"cfg": tcfg, **_load_jax_state(tcfg, jtr, binaries, True),
              "rays": tuple(torch.from_numpy(a) for a in (o, d, pix)),
              "jitters": [torch.from_numpy(np.array(jax.random.uniform(
                  jax.random.fold_in(key, r), (m,)))) for r in range(world_size)],
              "starts": [starts_from_key(tctx, jax.random.fold_in(key, r))
                         for r in range(world_size)]}
    return inputs, jgrads, jbits


def _plain_step(inputs, world_size):
    """`dp_step_plain` on the same state, batch and draws, in this process."""
    tr = dp_ranks.make_trainer(inputs["cfg"], world_size)
    dp_ranks.load_state(tr, inputs)
    cache = tr.entropy.refresh_cache(tr.occ_state.binaries)
    aux = sharding.dp_step_plain(tr, world_size, *inputs["rays"], torch.ones(3),
                                 jitters=inputs["jitters"], ent_cache=cache,
                                 starts=inputs["starts"], apply=False)
    return aux, {k: v.numpy() for k, v in dp_ranks.grads(tr).items()}


@pytest.mark.parametrize("pn_frac_grad", [False, True], ids=["plane_detached", "pn_frac_grad"])
def test_rate_step_matches_dp_step_plain_and_cnc_tpu_mesh(pn_frac_grad, tmp_path):
    """One lambda = 2e-3 step over 2 gloo ranks (entropy model with the
    per-rank quotas, rank r's windows from starts_from_key(fold_in(key, r)),
    its jitter from fold_in(key, r)) against `dp_step_plain` on the same
    draws and against cnc_tpu's `Trainer(mesh=make_mesh(2))` step, with the
    frac planes detached (the default) and with their gradient
    (pn_frac_grad): the mean bits and every reduced gradient, the four
    tables and both MLPs' layers, the frac planes' rows split over the ranks
    (K7p's twin) and summed (`all_reduce_sum`, whose backward is the sum of
    the ranks' cotangents)."""
    world_size = 2
    ent = {"pn_frac_grad": pn_frac_grad}
    tcfg, jcfg = dp_ranks.tiny_config(entropy=ent), dp_ranks.tiny_config(jconfig, entropy=ent)
    inputs, jgrads, jbits = _rate_step_inputs(tcfg, jcfg, world_size)
    outs = _run(dp_ranks.step_rank, world_size, tmp_path, "step", inputs)
    got = {k: v.numpy() for k, v in outs[0]["grads"].items()}
    for out in outs[1:]:
        assert all(torch.equal(out["grads"][k], outs[0]["grads"][k]) for k in got)
    paux, pgrads = _plain_step(inputs, world_size)
    taux = outs[0]["aux"]
    assert int(taux["n_marched"]) == int(paux["n_marched"]) > 500
    np.testing.assert_allclose(float(taux["mse"]), float(paux["mse"]), rtol=1e-6)
    np.testing.assert_allclose(float(taux["bits_per_param"]), float(paux["bits_per_param"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux["bits_per_param"]), jbits, rtol=1e-5)
    assert len(got) == 22 and np.abs(got["field.tables.xyz"]).max() > 0
    _assert_grads_close(got, pgrads)
    _assert_grads_close(got, jgrads)


# ------------------------------------------------------ port only
def test_collective_steps_equal_dp_step_plain_and_stay_replicated(tmp_path):
    """Three lambda = 2e-3 steps over 2 gloo ranks on the sphere scene, each
    held to `dp_step_plain` run by rank 0 from the same state and draws: the
    gradients, the mse, the sample counts and the bits; the ranks' field,
    context MLPs and occupancy grid bit-equal after every step."""
    world_size = 2
    outs = _run(dp_ranks.plain_rank, world_size, tmp_path, "plain",
                {"cfg": dp_ranks.tiny_config(), "steps": 3, "rays": 256})
    for s, rec in enumerate(outs[0]["steps"]):
        got, want = rec["aux"], rec["plain_aux"]
        assert got["n_marched"] == want["n_marched"] > 500, s
        assert got["n_samples"] == want["n_samples"], s
        for k in ("mse", "bits_per_param", "ctx_util"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=f"step {s} {k}")
        assert len(rec["dp"]) == 22
        _assert_grads_close({k: v.numpy() for k, v in rec["dp"].items()},
                            {k: v.numpy() for k, v in rec["plain"].items()})
        assert all(torch.equal(outs[1]["steps"][s]["dp"][k], rec["dp"][k]) for k in rec["dp"])
    assert all(torch.equal(outs[1]["state"][k], v) for k, v in outs[0]["state"].items())


def test_resumed_run_equals_the_unbroken_run(tmp_path):
    """Two ranks train to step 23, rank 0 saving a checkpoint once `fit` has
    returned at step 16; two fresh ranks resume from it (both read rank 0's
    file) and train to step 23: every step's mse and bits and the final
    field, context MLPs, occupancy grid, generator and ray count equal the
    unbroken run's bit for bit; the ranks' replicas are checked after every
    step of both runs."""
    world_size, save = 2, str(tmp_path / "ckpt.npz")
    cfg = dp_ranks.tiny_config()
    full = _run(dp_ranks.fit_rank, world_size, tmp_path, "fit",
                {"cfg": cfg, "last": 23, "save_at": 16, "save_path": save})
    assert os.path.exists(save)
    resumed_dir = tmp_path / "resumed"
    resumed_dir.mkdir()
    cfg_resume = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                    checkpoint_path=save))
    resumed = _run(dp_ranks.fit_rank, world_size, resumed_dir, "fit",
                   {"cfg": cfg_resume, "last": 23})
    for r in range(world_size):
        assert resumed[r]["start"] == 16
        a = [(h["step"], h["mse"], h["bits"], h["n_marched"]) for h in full[r]["hist"][16:]]
        b = [(h["step"], h["mse"], h["bits"], h["n_marched"]) for h in resumed[r]["hist"]]
        assert a == b and len(b) == 8
        assert resumed[r]["num_rays"] == full[r]["num_rays"]
        assert torch.equal(resumed[r]["generator"], full[r]["generator"])
        for k, v in full[r]["state"].items():
            assert torch.equal(resumed[r]["state"][k], v), k


def test_run_pipeline_with_a_group(tmp_path):
    """`run_pipeline(group=)` over 2 gloo ranks at the tiny configuration:
    both ranks train, rank 0 alone evaluates, encodes, decodes and returns
    the result (its 23-column row written once, the codec lossless), the
    other rank returns None."""
    out_root = tmp_path / "out"
    outs = _run(dp_ranks.pipeline_rank, 2, tmp_path, "pipeline",
                {"cfg": dp_ranks.tiny_config(), "last": 5, "out_root": str(out_root)})
    assert outs[1]["cols"] is None
    cols = outs[0]["cols"]
    assert len(cols) == 23 and cols[0] == "sphere"
    psnr, psnr_codec = float(cols[1]), float(cols[4])
    assert np.isfinite(psnr) and abs(psnr - psnr_codec) < 0.05
    assert float(cols[8]) > 0                       # coded MB
    rows = (out_root / "results" / "Procedural" / "output.txt").read_text().splitlines()
    assert len(rows) == 1
    assert (out_root / "bitstreams" / "sphere" / "meta.json").exists()


def test_dryrun_multichip_two_ranks():
    line = sharding.dryrun_multichip(2, n_steps=10, device="cpu", timeout_s=RANKS_TIMEOUT_S,
                                     group_timeout_s=dp_ranks.GROUP_TIMEOUT_S)
    assert line.startswith("dryrun_multichip(2): ok") and "codec" in line


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the card here")
def test_dryrun_multichip_runs_on_the_card_by_default():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.dryrun_multichip(2)


def test_rank0_barrier_over_a_tcp_rendezvous(tmp_path):
    """Rank 0 hosts a tcp:// rendezvous's store: it must not leave the
    barrier, and close the store, before a rank that arrives late has seen
    it; a failed rank 0 makes the others raise."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        (tmp_path / "port").write_text(str(s.getsockname()[1]))
    sharding.run_ranks(dp_ranks.barrier_rank, 2, (2, str(tmp_path)), RANKS_TIMEOUT_S)
    outs = [torch.load(tmp_path / f"barrier_out{r}.pt") for r in range(2)]
    assert outs[0]["raised"] is None
    assert "rank 0 failed" in outs[1]["raised"]


def test_rank0_barrier_raises_at_its_deadline():
    """No rank waits without end: rank 1 for a rank 0 that never arrives,
    rank 0 for a rank that never acknowledges."""
    store = torch.distributed.HashStore()
    for rank, match in ((1, "rank 0 did not arrive"), (0, "0 of 1 ranks arrived")):
        group = sharding.Group(world_size=2, rank=rank, device=torch.device("cpu"),
                               process_group=None, store=torch.distributed.PrefixStore(
                                   f"r{rank}", store))
        with pytest.raises(TimeoutError, match=match):
            sharding.rank0_barrier(group, "never", timeout_s=0.5, poll_s=0.05)


def test_multichip_without_torchrun_raises(monkeypatch):
    """`--multichip` means "launched by torchrun"; without its environment
    the CLI names the launcher instead of training on one device."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for driver_name in ("nerf_synthetic", "tank_temples"):
        with pytest.raises(RuntimeError, match="torchrun"):
            cli.main([driver_name, "--multichip", "--device", "cpu", "--max_steps", "1"])


def test_make_group_refuses_what_it_cannot_give(tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    init = "file://" + str(tmp_path / "rendezvous")
    with pytest.raises(RuntimeError, match="torchrun"):
        sharding.make_group(device="cpu", init_method=init)
    with pytest.raises(ValueError, match="nccl"):
        sharding.make_group(1, 0, device="cpu", backend="nccl", init_method=init)
    with pytest.raises(ValueError, match="timeout_s"):
        sharding.make_group(1, 0, device="cpu", init_method=init, timeout_s=1800)
    with pytest.raises(RuntimeError, match="rendezvous"):
        sharding.make_group(1, 0, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        sharding.make_group(2, 2, device="cpu", init_method=init)


def test_group_of_one_is_the_single_process_step(tmp_path):
    """A gloo group of one rank in this process: `shard_rays` keeps every
    row, the trainer's step equals the trainer without a group on the same
    injected draws (one step body; the group's sums run over one rank),
    and a group on another device than the trainer's is refused."""
    group = sharding.make_group(1, 0, device="cpu",
                                init_method="file://" + str(tmp_path / "rendezvous"),
                                timeout_s=dp_ranks.GROUP_TIMEOUT_S)
    try:
        x = torch.arange(12.0).reshape(4, 3)
        (y,) = sharding.shard_rays(group, x)
        assert torch.equal(y, x)
        cfg = dp_ranks.tiny_config()
        a = dp_ranks.make_trainer(cfg, 1, group)
        b = dp_ranks.make_trainer(cfg, 1)
        assert a.device == b.device == torch.device("cpu") and a.world_size == 1
        binaries = torch.from_numpy(_sphere_occupancy())
        for tr in (a, b):
            tr.occ_state = tr.occ_state._replace(binaries=binaries.clone())
        cache = b.entropy.refresh_cache(binaries)
        o, d, pix = (torch.from_numpy(v) for v in _sphere_rays(16, np.random.default_rng(0)))
        jitter = torch.rand(o.shape[0], generator=torch.Generator().manual_seed(3))
        starts = b.entropy.draw_starts(torch.Generator().manual_seed(4))
        aux_a = a._train_step(o, d, pix, torch.ones(3), jitter=jitter, ent_cache=cache,
                              starts=starts)
        aux_b = b._train_step(o, d, pix, torch.ones(3), jitter=jitter, ent_cache=cache,
                              starts=starts)
        assert int(aux_a["n_marched"]) == int(aux_b["n_marched"])
        for k in ("mse", "bits_per_param"):
            np.testing.assert_allclose(float(aux_a[k]), float(aux_b[k]), rtol=1e-6)
        for (k, pa), pb in zip(a.field.named_parameters(), b.field.parameters()):
            assert torch.equal(pa.grad, pb.grad), k
            assert torch.equal(pa, pb), k
        elsewhere = dataclasses.replace(group, device=torch.device("meta"))
        with pytest.raises(ValueError, match="group"):
            ttrainer.Trainer(cfg, None, device="cpu", group=elsewhere)
        with pytest.raises(ValueError, match="split"):
            sharding.shard_rays(dataclasses.replace(group, world_size=3), x)
    finally:
        sharding.destroy_group(group)
