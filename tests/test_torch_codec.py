"""cnc_torch's codec against cnc_tpu's, at tests/test_context_models.py:
tiny_setup's size.

Integers and bytes, so everything is held exactly: the codec cache, the
chunking and per-level shifts, every integer pool, every stream file of an
encode, checks.json, the Pg dictionary and the MB figures; a bundle of each
package decodes in the other to the same tables; the desync and format
checks; the port's versions of cnc_tpu's tail-window and 2D coverage tests;
the MLP quantization and the bundle's npz keys.  Two variants: one chunk per
3D level, and a chunk budget small enough to split the last level.
"""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.codec import codec as jcodec
from cnc_tpu.utils import checkpoint as jckpt
from cnc_torch.codec import codec as tcodec
from cnc_torch.codec import intctx as tint
from cnc_torch.models import context_models as tcm
from cnc_torch.ops import hash_ops
from cnc_torch.utils import checkpoint as tckpt

from test_torch_context_tables import asymmetric_occupancy, make_pair

# "chunked": 2 chunks on 3D level 2 and 9 on level 3
VARIANTS = {"whole": {}, "chunked": {"max_points_per_chunk": 1 << 15}}
TABLES = ("xyz", "xy", "xz", "yz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores: many small
    integer ops spread over every core's thread only contend, so this
    module's ops run on one thread (restored after it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sign_tables(tctx, seed, bias):
    rng = np.random.default_rng(seed)
    return {k: np.where(rng.standard_normal((s.total_entries, 2)) + bias > 0, 1.0,
                        -1.0).astype(np.float32)
            for k, s in zip(TABLES, (tctx.spec3, tctx.spec2, tctx.spec2, tctx.spec2))}


@pytest.fixture(scope="module", params=list(VARIANTS))
def setup(request, tmp_path_factory):
    jctx, tctx = make_pair(**VARIANTS[request.param])
    b = asymmetric_occupancy(seed=4)
    tabs = _sign_tables(tctx, 42, 0.5)                       # biased toward +1
    jp = jctx.init_params(jax.random.PRNGKey(1))
    jp_np = jax.tree.map(np.asarray, jp)
    tp = tctx.ent_params_from_jax(jp_np)
    jc, tc = jcodec.CNCCodec(jctx), tcodec.CNCCodec(tctx)
    dirs = {k: str(tmp_path_factory.mktemp(f"{request.param}_{k}")) for k in ("j", "t")}
    jres = jc.encode(jp, {k: jnp.asarray(v) for k, v in tabs.items()}, jnp.asarray(b), dirs["j"])
    tcache = tctx.refresh_cache_int(torch.from_numpy(b))
    tres = tc.encode(tp, {k: torch.from_numpy(v) for k, v in tabs.items()}, torch.from_numpy(b),
                     dirs["t"], cache=tcache)
    return dict(variant=request.param, jctx=jctx, tctx=tctx, b=b, tabs=tabs, jp=jp, jp_np=jp_np,
                tp=tp, jc=jc, tc=tc, dirs=dirs, jres=jres, tres=tres, tcache=tcache,
                jcache=jctx.refresh_cache_int(jnp.asarray(b)))


@pytest.fixture(scope="module")
def decoded(setup):
    """The port's decode of its own streams and cnc_tpu's of its own."""
    trec = setup["tc"].decode(setup["tp"], torch.from_numpy(setup["b"]), setup["tres"][0],
                              setup["dirs"]["t"], cache=setup["tcache"])
    jrec = setup["jc"].decode(setup["jp"], jnp.asarray(setup["b"]), setup["jres"][0],
                              setup["dirs"]["j"])
    return trec, jrec


def test_refresh_cache_int_equal(setup):
    jc, tc = setup["jcache"], setup["tcache"]
    assert set(tc) == set(jc)
    for k in ("bin2d", "mask3d", "mask2d"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    assert set(tc["ovl_int"]) == set(jc["ovl_int"])
    for l in jc["ovl_int"]:
        assert tc["ovl_int"][l].dtype == torch.int32
        np.testing.assert_array_equal(tc["ovl_int"][l].numpy(), np.asarray(jc["ovl_int"][l]))
    for ax in tcm.AXES:
        for k in jc["pn"][ax]:
            np.testing.assert_array_equal(tc["pn"][ax][k].numpy(), np.asarray(jc["pn"][ax][k]))


def test_chunking_and_shifts_equal(setup):
    jc, tc = setup["jc"], setup["tc"]
    assert tc.chunks3d == jc.chunks3d
    assert (tc.m_shift3, tc.m_scale3, tc.m_shift2, tc.m_scale2) == \
        (jc.m_shift3, jc.m_scale3, jc.m_shift2, jc.m_scale2)
    for l in tc.chunks3d:
        assert tc._chunk_bounds(l) == jc._chunk_bounds(l)
    if setup["variant"] == "chunked":
        assert tc.chunks3d[setup["tctx"].ctx_levels_3d[-1]][1] > 1


def _int_params(setup):
    ip_t = setup["tc"]._int_params(setup["tp"])
    ip_j = setup["jc"]._int_params(setup["jp"])
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)), ip_t, ip_j)
    return ip_t, ip_j


def test_pool_3d_level_int_equal(setup):
    """msum, wsum, covered and values of every chunk of every 3D level (of
    the chunked level alone in the chunked variant)."""
    jctx, tctx, jc, tc = setup["jctx"], setup["tctx"], setup["jc"], setup["tc"]
    ip_t, ip_j = _int_params(setup)
    sign = setup["tabs"]["xyz"].astype(np.int32)
    covered = []
    levels = tctx.ctx_levels_3d[-1:] if setup["variant"] == "chunked" else tctx.ctx_levels_3d
    for l in levels:
        chunk_e, _, w = tc.chunks3d[l]
        for (_, _, start) in tc._chunk_bounds(l):
            want = jctx.pool_3d_level_int(ip_j, jnp.asarray(sign), setup["jcache"], l,
                                          jnp.int32(131), jnp.int32(start), chunk_e, w,
                                          jc.m_shift3[l])
            got = tctx.pool_3d_level_int(ip_t, torch.from_numpy(sign), setup["tcache"], l, 131,
                                         start, chunk_e, w, tc.m_shift3[l])
            for name, a, b in zip(("msum", "wsum", "covered", "values"), got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{l} {name}")
            covered.append(got[2])
    covered = torch.cat(covered)
    assert covered.any()


def test_pool_2d_level_int_equal(setup):
    """Every plane and 2D context level, with the integer frac plane (one
    plane in the chunked variant: the chunk budget is a 3D setting)."""
    jctx, tctx, jc, tc = setup["jctx"], setup["tctx"], setup["jc"], setup["tc"]
    ip_t, ip_j = _int_params(setup)
    sign3 = setup["tabs"]["xyz"].astype(np.int32)
    axes = tcm.AXES[:1] if setup["variant"] == "chunked" else tcm.AXES
    for ai, ax in enumerate(axes):
        jplane = jctx.frac_plane_int(jnp.asarray(sign3), setup["jcache"]["pn"][ax])
        tplane = tctx.frac_plane_int(torch.from_numpy(sign3), setup["tcache"]["pn"][ax])
        np.testing.assert_array_equal(tplane.numpy(), np.asarray(jplane))
        sign2 = setup["tabs"][ax].astype(np.int32)
        for l in tctx.ctx_levels_2d:
            t = tctx.tables2d[l]
            want = jctx.pool_2d_level_int(ip_j, jnp.asarray(sign2), l, jnp.int32(77), jplane,
                                          setup["jcache"]["mask2d"][ai], jnp.int32(0),
                                          t.n_entries, t.n_points, jc.m_shift2[l])
            got = tctx.pool_2d_level_int(ip_t, torch.from_numpy(sign2), l, 77, tplane,
                                         setup["tcache"]["mask2d"][ai], 0, t.n_entries,
                                         t.n_points, tc.m_shift2[l])
            for name, a, b in zip(("msum", "cnt", "covered", "values"), got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{ax}{l} {name}")


def test_streams_byte_identical(setup):
    """Every .b file, checks.json, the Pg dictionary and both MB figures."""
    jd, td = setup["dirs"]["j"], setup["dirs"]["t"]
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    streams = [n for n in names if n.endswith(".b")]
    assert len(streams) >= 4 + 3 * 2
    if setup["variant"] == "chunked":
        assert any(n.count("_") == 2 for n in streams)           # b_3D3_1.b
    for n in names:
        assert filecmp.cmp(os.path.join(jd, n), os.path.join(td, n), shallow=False), n
    with open(os.path.join(td, "b_checks.json")) as fh:
        checks = json.load(fh)
    assert checks["__format__"] == 3 and len(checks) == len(streams) + 1
    (jpgs, jest, jact), (tpgs, test_, tact) = setup["jres"], setup["tres"]
    assert tpgs == jpgs and list(tpgs) == list(jpgs)
    assert (test_, tact) == (jest, jact) and tact > 0


def test_decode_is_lossless_and_equals_cnc_tpu(setup, decoded):
    """Covered entries come back as trained, the others as +1, exactly as
    cnc_tpu's decode gives them."""
    trec, jrec = decoded
    tctx, tc = setup["tctx"], setup["tc"]
    for k in TABLES:
        assert trec[k].dtype == torch.float32
        np.testing.assert_array_equal(trec[k].numpy(), np.asarray(jrec[k]), err_msg=k)
    ip_t, _ = _int_params(setup)
    sign3 = torch.from_numpy(setup["tabs"]["xyz"].astype(np.int32))
    tbl3, rec3 = setup["tabs"]["xyz"], trec["xyz"].numpy()
    for l in range(tctx.spec3.n_levels):
        off, size = tctx.spec3.offsets[l], tctx.spec3.level_sizes[l]
        if tc._is_global_3d(l):
            np.testing.assert_array_equal(rec3[off:off + size], tbl3[off:off + size])
            continue
        chunk_e, _, w = tc.chunks3d[l]
        pg_q = tint.quantize_pg(setup["tres"][0][f"3D{l}"])
        for (lo, hi, start) in tc._chunk_bounds(l):
            _, covered, _ = tc._pool3d(l, ip_t, sign3, setup["tcache"], pg_q, start)
            cov = covered.numpy()[lo - start:hi - start]
            rows = off + tctx.entry_values_np("3d", l)[lo:hi]
            np.testing.assert_array_equal(rec3[rows][cov], tbl3[rows][cov])
            assert np.all(rec3[rows][~cov] == 1.0)
    for ax in tcm.AXES:
        off, size = tctx.spec2.offsets[0], tctx.spec2.level_sizes[0]
        np.testing.assert_array_equal(trec[ax].numpy()[off:off + size],
                                      setup["tabs"][ax][off:off + size])


def _mlp_tree(seed):
    rng = np.random.default_rng(seed)
    lin = lambda i, o: {"w": rng.standard_normal((i, o)).astype(np.float32),
                        "b": rng.standard_normal(o).astype(np.float32)}
    return {"mlp_base": {"l0": lin(6, 8), "l1": lin(8, 3)},
            "mlp_head": {"l0": lin(5, 8), "l1": lin(8, 8), "l2": lin(8, 3)}}


def test_cnc_tpu_bundle_decodes_in_port(setup, decoded, tmp_path):
    d = tmp_path / "b"
    shutil.copytree(setup["dirs"]["j"], d)
    mlp = _mlp_tree(1)
    jcodec.save_bundle(str(d), setup["jres"][0], setup["jp"], jax.tree.map(jnp.asarray, mlp),
                       jnp.asarray(setup["b"]), {"scene": "test"})
    pgs, ent, mlp2, b = tcodec.load_bundle(str(d))
    assert pgs == setup["jres"][0]
    np.testing.assert_array_equal(b, setup["b"])
    jax.tree.map(np.testing.assert_array_equal, mlp2, mlp)
    jax.tree.map(np.testing.assert_array_equal, ent, setup["jp_np"])
    rec = setup["tc"].decode(ent, torch.from_numpy(b), pgs, str(d))
    for k in TABLES:
        np.testing.assert_array_equal(rec[k].numpy(), decoded[0][k].numpy(), err_msg=k)


def test_port_bundle_decodes_in_cnc_tpu(setup, decoded, tmp_path):
    d = tmp_path / "b"
    shutil.copytree(setup["dirs"]["t"], d)
    mlp = _mlp_tree(2)
    tcodec.save_bundle(str(d), setup["tres"][0], setup["tp"], mlp, torch.from_numpy(setup["b"]),
                       {"scene": "test"})
    jctx = setup["jctx"]
    template = jctx.init_params(jax.random.PRNGKey(0))
    pgs, ent, mlp2, b = jcodec.load_bundle(str(d), template, jax.tree.map(jnp.zeros_like, mlp))
    assert pgs == setup["tres"][0]
    jax.tree.map(lambda a, w: np.testing.assert_array_equal(np.asarray(a), w), mlp2, mlp)
    rec = setup["jc"].decode(ent, jnp.asarray(b), pgs, str(d))
    for k in TABLES:
        np.testing.assert_array_equal(np.asarray(rec[k]), decoded[0][k].numpy(), err_msg=k)


def test_bundle_keys_equal_cnc_tpu_flatten(setup):
    """The npz keys (and leaves) of ent and MLP trees: cnc_tpu's keystr form."""
    ent = tcm.ContextModels.ent_params_to_numpy(setup["tp"])
    jax.tree.map(np.testing.assert_array_equal, ent, setup["jp_np"])
    for tree, prefix in ((ent, "ent"), (_mlp_tree(3), "mlp")):
        want = jckpt._flatten(jax.tree.map(jnp.asarray, tree), prefix)
        got = tckpt._flatten(tree, prefix)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert tckpt._nest(got, prefix).keys() == tree.keys()
    assert "ent|['ctx3d']['l0']['w']" in tckpt._flatten(ent, "ent")
    assert "mlp|['mlp_base']['l0']['w']" in tckpt._flatten(_mlp_tree(3), "mlp")


def test_wrong_occupancy_desyncs_loudly(setup):
    wrong = torch.zeros(16, 16, 16, dtype=torch.bool)
    wrong[0, 0, 0] = True
    with pytest.raises(ValueError, match="codec desync"):
        setup["tc"].decode(setup["tp"], wrong, setup["tres"][0], setup["dirs"]["t"])


def test_format_version_and_missing_checks(setup, tmp_path):
    d = tmp_path / "b"
    shutil.copytree(setup["dirs"]["t"], d)
    path = d / "b_checks.json"
    checks = json.loads(path.read_text())
    checks["__format__"] = 2
    path.write_text(json.dumps(checks))
    with pytest.raises(ValueError, match="format v2"):
        setup["tc"].decode(setup["tp"], torch.from_numpy(setup["b"]), setup["tres"][0], str(d))
    path.unlink()
    with pytest.raises(FileNotFoundError, match="checks.json"):
        setup["tc"].decode(setup["tp"], torch.from_numpy(setup["b"]), setup["tres"][0], str(d))


def test_quantize_mlp_params_equal():
    tree = _mlp_tree(4)
    tree["mlp_head"]["l2"]["b"][:] = 0.25              # a constant leaf
    for digits in (8, 13):
        want = jcodec.quantize_mlp_params(jax.tree.map(jnp.asarray, tree), digits)
        got = tcodec.quantize_mlp_params(tree, digits)
        assert got[:2] == want[:2]
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), got[2],
                     want[2])
    torch_tree = jax.tree.map(torch.from_numpy, tree)
    jax.tree.map(np.testing.assert_array_equal, tcodec.quantize_mlp_params(torch_tree)[2],
                 tcodec.quantize_mlp_params(tree)[2])


def test_chunked_tail_window_coverage(tmp_path):
    """The port's version of tests/test_codec.py's round-3 regression: with
    the last 3D level coded in many chunks, every entry with at least one
    footprint-valid vertex comes back with its trained sign (the last chunk's
    window is end-clamped), and the frac planes of the decoded table equal
    the trained table's (the desync channel into the 2D streams)."""
    _, tctx = make_pair(max_points_per_chunk=1 << 13)
    cd = tcodec.CNCCodec(tctx)
    assert cd.chunks3d[tctx.ctx_levels_3d[-1]][1] > 1
    b = torch.from_numpy(np.random.default_rng(3).random((16, 16, 16)) < 0.2)
    tabs = {k: torch.from_numpy(v) for k, v in _sign_tables(tctx, 3, -0.3).items()}
    params = tctx.init_params(torch.Generator().manual_seed(5))
    pgs, _, _ = cd.encode(params, tabs, b, str(tmp_path))
    rec = cd.decode(params, b, pgs, str(tmp_path))                 # raises on desync
    cache = tctx.refresh_cache_int(b)
    mask3d = cache["mask3d"].numpy()
    sign3 = tint.sign_table(tabs["xyz"]).numpy()
    rec3 = rec["xyz"].to(torch.int32).numpy()
    for l in tctx.ctx_levels_3d:
        t = tctx.tables3d[l]
        arrs = tctx.level_arrays_np("3d", l)
        valid_v = mask3d[tctx.mask3d_offsets[l] + arrs["pos_flat"]]
        cum = arrs["cum"].astype(np.int64)
        has_valid = np.add.reduceat(valid_v.astype(np.int64),
                                    np.minimum(cum[:-1], valid_v.size - 1))[:t.n_entries] > 0
        has_valid &= (cum[1:] > cum[:-1])[:t.n_entries]
        slots = arrs["entry_values"][:t.n_entries][has_valid]
        np.testing.assert_array_equal(rec3[t.offset + slots], sign3[t.offset + slots],
                                      err_msg=f"3D level {l}: covered entry not reconstructed")
    for ax in tcm.AXES:
        assert torch.equal(tctx.frac_plane_int(torch.from_numpy(rec3), cache["pn"][ax]),
                           tctx.frac_plane_int(torch.from_numpy(sign3), cache["pn"][ax])), ax


def test_2d_gather_mask_implies_coverage(setup):
    """Every coord the 2D context gathers treat as valid (footprint mask
    true) belongs to a coded entry, on every plane and context level."""
    tctx, tc = setup["tctx"], setup["tc"]
    ip_t, _ = _int_params(setup)
    sign3 = torch.from_numpy(setup["tabs"]["xyz"].astype(np.int32))
    mask2d = setup["tcache"]["mask2d"]
    for ai, ax in enumerate(tcm.AXES):
        plane_q = tctx.frac_plane_int(sign3, setup["tcache"]["pn"][ax])
        sign2 = torch.from_numpy(setup["tabs"][ax].astype(np.int32))
        for l in tctx.ctx_levels_2d:
            r = tctx.tables2d[l].resolution
            _, covered, _ = tc._pool2d(l, ip_t, sign2, 128, plane_q, mask2d[ai])
            by_entry = np.zeros(tctx.spec2.level_sizes[l], bool)
            by_entry[tctx.entry_values_np("2d", l)] = covered.numpy()
            off = tctx.mask2d_offsets[l]
            xs, ys = np.nonzero(mask2d[ai][off:off + r * r].numpy().reshape(r, r))
            idx = hash_ops.grid_index(torch.from_numpy(np.stack([xs, ys], -1)), r,
                                      tctx.spec2.level_sizes[l]).numpy()
            assert len(idx) and by_entry[idx].all(), f"{ax}{l}"


def test_refresh_cache_int_rejects_another_grid_size(setup):
    with pytest.raises(ValueError, match="Rb"):
        setup["tctx"].refresh_cache_int(torch.zeros(32, 32, 32, dtype=torch.bool))
