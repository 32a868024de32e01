"""Sharded persistence and eviction on a 4-rank gloo group: the loops'
`delta_ckpt`, `ckpt_manager`, `guard` and `evict_every` beside a mesh, for
every family, against JAX's loops on its `local_mesh(4)`; the delta files
crossing between the packages in both directions; bases restored across
layouts (a flat base into a sharded model, a sharded one into a flat
model); `evict_rows_sharded` against JAX's; the guard's verdict reduced
over the ranks.

Tolerances: JAX's sharded tests' (CTR tables rtol 2e-4 / atol 1e-6, the
two-tower model's rtol 5e-4 / atol 1e-5, losses rtol 1e-5 and 1e-4) where
the two packages' steps meet; bitwise where one package restores what it
wrote, and for eviction (it writes zeros and moves nothing else).
"""
import os
import shutil

import numpy as np
import pytest

import jax

from embeddingtables_tpu.models import train as JT
from embeddingtables_tpu.parallel import dlrm as JP
from embeddingtables_tpu.parallel.mesh import local_mesh
from embeddingtables_tpu.utils import deltackpt as JDC
from embeddingtables_tpu.utils import rowstats as JR
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.utils import DeltaCheckpointManager
from _torch_mesh import MeshPool, model_out
from _torch_persist import pair
from _torch_threads import _one_torch_thread  # noqa: F401
from test_torch_sharded_families import (JAPI, TABLE, TT_TABLE,
                                         assert_model_close, base,
                                         family_arrays, global_batches,
                                         jax_out)

FAMILIES = ("dlrm", "dcn", "deepfm_unfolded", "two_tower")
JAPI = dict(JAPI, dlrm=(JP.shard_dlrm, JP.make_sharded_train_step,
                        JP.make_sharded_eval_step, JP.unshard_dlrm))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(4, str(tmp_path_factory.mktemp("mesh")))
    yield p
    p.close()


def keys(family):
    return (("dense", "q_cat", "item_ids") if family == "two_tower"
            else ("dense", "cat", "label"))


def dicts(family, data):
    return [dict(zip(keys(family), b)) for b in data]


def table_tol(family):
    return TT_TABLE if family == "two_tower" else TABLE


def managers(family, root, name, base_every=8):
    """The family's delta manager(s) in both packages' directory shape: a
    directory, or a query and an item directory."""
    if family == "two_tower":
        return [str(root / f"{name}_q"), str(root / f"{name}_i")]
    return str(root / name)


def jax_managers(dirs, base_every=8):
    if isinstance(dirs, list):
        return tuple(JDC.DeltaCheckpointManager(d, base_every=base_every)
                     for d in dirs)
    return JDC.DeltaCheckpointManager(dirs, base_every=base_every)


def port_managers(dirs):
    if isinstance(dirs, list):
        return tuple(DeltaCheckpointManager(d) for d in dirs)
    return DeltaCheckpointManager(dirs)


def as_list(dirs):
    return dirs if isinstance(dirs, list) else [dirs]


def swap_deltas(base_dir, delta_dir, out):
    """`out`: a copy of `base_dir`'s chain with `delta_dir`'s delta files
    in place of its own."""
    shutil.copytree(base_dir, out)
    for name in os.listdir(out):
        if name.startswith("delta_"):
            os.unlink(os.path.join(out, name))
    for name in os.listdir(delta_dir):
        if name.startswith("delta_"):
            shutil.copy(os.path.join(delta_dir, name), out)


def jax_loop(family, jcfg, jopt, jm, data, **kw):
    return getattr(JT, "train_" + base(family))(
        jcfg, iter(dicts(family, data)), len(data), sparse_opt=jopt,
        model=jm, mesh=local_mesh(4), axis="data", verbose=False, **kw)


def jax_final(family, res):
    return jax_out(res.model if family == "two_tower"
                   else JAPI[base(family)][3](res.model))


@pytest.mark.parametrize("family", FAMILIES)
def test_loop_delta_chain_on_a_mesh_crosses_to_jax_and_back(pool, family,
                                                             tmp_path):
    """Both packages' loops write a chain on the mesh (a mod-layout base at
    step 1, deltas at 2-4). The delta files hold the same rows, keyed by
    global row; the port's deltas on JAX's base restore in JAX, and JAX's
    on the port's base in the port, into a flat and a sharded model, each
    within the steps' tolerance of JAX's trained model."""
    (jcfg, jopt, jm), (pcfg, popt, _) = pair(family, "adagrad")
    data = global_batches(family, n=4, seed=7)
    pdirs, jdirs = (managers(family, tmp_path, n) for n in ("port", "jax"))
    kw = dict(delta_every=1, log_every=1, dense_lr=0.1)
    got = pool.submit("family_loop", "data", base(family), pcfg,
                      family_arrays(family, jm), popt, data,
                      dict(kw, delta_dir=pdirs))
    res = jax_loop(family, jcfg, jopt, jm, data, delta_ckpt=jax_managers(
        jdirs), **kw)
    got = got()
    want = jax_final(family, res)
    tol = table_tol(family)
    assert_model_close(got[0], want, tol)
    for p, j in zip(as_list(pdirs), as_list(jdirs)):
        assert sorted(n for n in os.listdir(p) if n.startswith("delta_")) \
            == [f"delta_{s}.npz" for s in (2, 3, 4)]
        for s in (2, 3, 4):
            pz = np.load(os.path.join(p, f"delta_{s}.npz"))
            jz = np.load(os.path.join(j, f"delta_{s}.npz"))
            assert sorted(pz.files) == sorted(jz.files)
            np.testing.assert_array_equal(pz["rows"], jz["rows"])
            for k in pz.files:
                if pz[k].size or jz[k].size:
                    np.testing.assert_allclose(pz[k], jz[k], **tol)
    # The port's deltas on JAX's base, in JAX: a flat and a sharded model.
    xdirs = [str(tmp_path / f"x{i}") for i in range(len(as_list(jdirs)))]
    for p, j, x in zip(as_list(pdirs), as_list(jdirs), xdirs):
        swap_deltas(j, p, x)
    xdirs = xdirs if family == "two_tower" else xdirs[0]
    fresh_jax = pair(family, "adagrad", seed=9)[0][2]
    flat = JT.restore_delta(jax_managers(xdirs), fresh_jax)
    assert_model_close(jax_out(flat), rows_only(want), tol)
    fresh_jax = pair(family, "adagrad", seed=9)[0][2]
    sharded = JT.restore_delta(jax_managers(xdirs), JAPI[base(family)][0](
        fresh_jax, local_mesh(4), "data", sparse_opt=jopt))
    assert_model_close(jax_out(JAPI[base(family)][3](sharded)),
                       rows_only(want), tol)
    # JAX's deltas on the port's base, in the port: flat and sharded.
    ydirs = [str(tmp_path / f"y{i}") for i in range(len(as_list(pdirs)))]
    for p, j, y in zip(as_list(pdirs), as_list(jdirs), ydirs):
        swap_deltas(p, j, y)
    ydirs = ydirs if family == "two_tower" else ydirs[0]
    fresh = pair(family, "adagrad", seed=9)
    flat = ett.restore_delta(port_managers(ydirs), fresh[1][2])
    assert_model_close(model_out(flat), rows_only(want), tol)
    for g in pool.run("family_restore", "data", base(family), pcfg,
                      family_arrays(family, fresh[0][2]), popt, ydirs):
        assert_model_close(g, rows_only(want), tol)


def assert_bitwise(got, want):
    assert_model_close(got, want, dict(rtol=0, atol=0))


def rows_only(out):
    """The tables and row state of a model (what a delta chain holds)."""
    return {k: v for k, v in out.items() if k != "towers"}


@pytest.mark.parametrize("family", ["dlrm", "deepfm_unfolded", "two_tower"])
def test_a_flat_base_restores_into_a_sharded_model_bitwise(pool, family,
                                                           tmp_path):
    (_, _, jm), (pcfg, popt, pm) = pair(family, "adagrad")
    dirs = managers(family, tmp_path, "flat")
    data = global_batches(family, n=3, seed=4)
    getattr(ett, "train_" + base(family))(
        pcfg, iter(dicts(family, data)), 3, sparse_opt=popt, model=pm,
        delta_ckpt=port_managers(dirs), delta_every=1, log_every=0,
        verbose=False, dense_lr=0.1, device="cpu")
    fresh = pair(family, "adagrad", seed=9)
    want = model_out(ett.restore_delta(port_managers(dirs), fresh[1][2]))
    for g in pool.run("family_restore", "data", base(family), pcfg,
                      family_arrays(family, fresh[0][2]), popt, dirs):
        assert_bitwise(rows_only(g), rows_only(want))


@pytest.mark.parametrize("family", ["dlrm", "deepfm_unfolded", "two_tower"])
def test_a_sharded_base_restores_into_a_flat_model_bitwise(pool, family,
                                                           tmp_path):
    """The mesh loop's chain (a base in 4 parts, then deltas): restored
    into a single-device model and into a sharded one, each bitwise the
    trained model's tables and row state."""
    (_, _, jm), (pcfg, popt, _) = pair(family, "adagrad")
    dirs = managers(family, tmp_path, "mesh")
    data = global_batches(family, n=3, seed=4)
    got = pool.run("family_loop", "data", base(family), pcfg,
                   family_arrays(family, jm), popt, data,
                   dict(delta_dir=dirs, delta_every=1, log_every=0))
    trained = {k: v for k, v in got[0].items()
               if k in ("tables", "items", "fm", "state")}
    assert sorted(os.listdir(os.path.join(as_list(dirs)[0], "base_1"))) == \
        ["part_0", "part_1", "part_2", "part_3", "parts.json"]
    fresh = pair(family, "adagrad", seed=9)
    flat = model_out(ett.restore_delta(port_managers(dirs), fresh[1][2]))
    assert_bitwise({k: flat[k] for k in trained}, trained)
    for g in pool.run("family_restore", "data", base(family), pcfg,
                      family_arrays(family, fresh[0][2]), popt, dirs):
        assert_bitwise({k: g[k] for k in trained}, trained)


def test_a_sharded_base_restores_onto_another_rank_count_bitwise(
        pool, tmp_path_factory):
    """A chain written by 4 ranks (a base of 4 parts, then deltas) restored
    by 2 ranks: each row re-laid by global row, bitwise the trained
    model's tables and state."""
    (_, _, jm), (pcfg, popt, _) = pair("deepfm_unfolded", "adam")
    root = tmp_path_factory.mktemp("ranks")
    data = global_batches("deepfm_unfolded", n=3, seed=4)
    got = pool.run("family_loop", "data", "deepfm", pcfg,
                   family_arrays("deepfm_unfolded", jm), popt, data,
                   dict(delta_dir=str(root / "chain"), delta_every=1,
                        log_every=0))
    pool2 = MeshPool(2, str(root))
    try:
        fresh = pair("deepfm_unfolded", "adam", seed=9)[0][2]
        back = pool2.run("family_restore", "data", "deepfm", pcfg,
                         family_arrays("deepfm_unfolded", fresh), popt,
                         str(root / "chain"))
    finally:
        pool2.close()
    for g in back:
        assert_bitwise(rows_only(g), {k: got[0][k] for k in rows_only(g)})


@pytest.mark.parametrize("family,opt", [
    ("dlrm", "sgd"), ("dlrm", "adagrad"), ("dlrm", "adam"), ("dlrm", "ftrl"),
    ("deepfm_unfolded", "adagrad")])
def test_evict_rows_sharded_matches_jax(pool, family, opt):
    """Evicted rows and their state cells go to 0 (AdaGrad's too, not to
    its initial accumulator), on every stack; Adam's count and SGD's empty
    placeholder pass through; everything else is untouched. Rows 50-55
    lie past the 49-row vocab: those inside a shard's padding are zeroed,
    those past it dropped."""
    (jcfg, jopt, jm), (pcfg, popt, _) = pair(family, opt)
    rows = np.asarray([0, 5, 13, 30, 48, 50, 53, 55], np.int32)
    got = pool.run("family_evict", "data", base(family), pcfg,
                   family_arrays(family, jm), popt, rows)
    import dataclasses
    mesh = local_mesh(4)
    sm = JAPI[base(family)][0](jm, mesh, "data", sparse_opt=jopt)
    st, acc = JR.evict_rows_sharded(sm.tables, sm.emb_accum, rows)
    sm = dataclasses.replace(sm, tables=st, emb_accum=acc)
    if getattr(sm, "fm_w", None) is not None:
        sw, facc = JR.evict_rows_sharded(sm.fm_w, sm.fm_accum, rows)
        sm = dataclasses.replace(sm, fm_w=sw, fm_accum=facc)
    want = jax_out(JAPI[base(family)][3](sm))
    for g in got:
        assert_bitwise(g, want)
    assert not got[0]["tables"][rows[rows < 49]].any()


@pytest.mark.parametrize("family", ["dlrm", "deepfm_unfolded"])
def test_loop_eviction_on_a_mesh_matches_jax(pool, family, tmp_path):
    """`evict_every=2` with a delta chain beside it: every rank's trackers
    follow the same global batches and evict the same rows, as JAX's loop
    does; the evicted rows are in the next delta."""
    (jcfg, jopt, jm), (pcfg, popt, _) = pair(family, "adagrad")
    data = global_batches(family, n=4, seed=3, b=8)
    kw = dict(evict_every=2, evict_threshold=0.6, freq_decay=0.5,
              log_every=1, dense_lr=0.1)
    got = pool.submit("family_loop", "data", base(family), pcfg,
                      family_arrays(family, jm), popt, data,
                      dict(kw, delta_dir=str(tmp_path / "p"), delta_every=2))
    res = jax_loop(family, jcfg, jopt, jm, data, delta_ckpt=jax_managers(
        str(tmp_path / "j")), delta_every=2, **kw)
    got = got()
    assert res.evicted_rows > 0
    assert all(g["evicted"] == res.evicted_rows for g in got)
    assert_model_close(got[0], jax_final(family, res), TABLE)
    pz, jz = (np.load(str(tmp_path / d / "delta_4.npz")) for d in "pj")
    np.testing.assert_array_equal(pz["rows"], jz["rows"])


def test_guard_rolls_back_every_rank_on_a_nan_batch(pool, tmp_path):
    """The third global batch's dense features are NaN: every rank's guard
    rolls back to the checkpoint of step 2 (one part a rank), and the run
    ends bitwise where a run without that batch ends."""
    (_, _, jm), (pcfg, popt, _) = pair("dlrm", "adagrad")
    data = global_batches("dlrm", n=4, seed=5)
    bad = list(data)
    bad[2] = (np.full_like(data[2][0], np.nan),) + tuple(data[2][1:])
    arrays = family_arrays("dlrm", jm)
    got = pool.run("family_loop", "data", "dlrm", pcfg, arrays, popt, bad,
                   dict(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1,
                        guard=True, log_every=1))
    want = pool.run("family_loop", "data", "dlrm", pcfg, arrays, popt,
                    data[:2] + data[3:], dict(log_every=1))
    for g in got:
        assert g["rollbacks"] == 1 and np.isnan(g["losses"][2])
        assert_bitwise({k: v for k, v in g.items() if k in ("tables",
                                                            "state",
                                                            "towers")},
                       {k: v for k, v in want[0].items()
                        if k in ("tables", "state", "towers")})
    assert sorted(os.listdir(tmp_path / "ckpt" / "4")) == \
        ["part_0", "part_1", "part_2", "part_3", "parts.json"]


def test_guard_verdict_is_reduced_over_the_ranks(pool):
    """One rank's bad loss makes every rank's guard read NaN and roll
    back (ROADMAP.md queue 3, "The guard's verdict on a mesh")."""
    got = pool.run("guard_agree", [0.5, float("nan"), 0.5, 0.5])
    assert all(np.isnan(seen) and rolled for seen, rolled in got)
    got = pool.run("guard_agree", [0.5, 0.5, 0.5, 0.5])
    assert all(seen == 0.5 and not rolled for seen, rolled in got)


@pytest.mark.parametrize("family", FAMILIES)
def test_a_full_checkpoint_of_a_sharded_model_restores_bitwise(pool, family,
                                                               tmp_path):
    """One part a rank; restored into the same placement, bitwise."""
    (_, _, jm), (pcfg, popt, _) = pair(family, "adam")
    other = pair(family, "adam", seed=9)[0][2]
    for saved, restored, listing in pool.run(
            "family_ckpt", "data", base(family), pcfg,
            family_arrays(family, jm), family_arrays(family, other), popt,
            str(tmp_path)):
        assert_bitwise(restored, saved)
        assert listing == ["part_0", "part_1", "part_2", "part_3",
                           "parts.json"]
