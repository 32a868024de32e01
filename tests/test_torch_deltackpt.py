"""The port's delta checkpoints (`utils/deltackpt.py`) against the JAX
package's, on the CPU.

  - `TouchedRowTracker` is the JAX package's numpy code: rows held exactly.
  - `snapshot_delta` gives JAX's dict key by key (`rows`, `vals`,
    `srow_<i>` / `sfull_<i>` in the state's leaf order) for the SGD,
    AdaGrad, lazy Adam and FTRL states, bitwise; `apply_delta` restores a
    changed state bitwise.
  - A delta file written by either package loads in the other, f32 and
    bf16 tables (bf16 as its uint16 view with a `__mldt` entry).
  - The same saves through both managers give the same file names, steps
    and restored values: pruning on a base, `force_base`, reopening
    mid-cadence, an empty directory. Bases differ in format (orbax against
    torch files), so each manager restores its own.
  - The loops' `delta_ckpt` (DLRM, DCN, DeepFM in both layouts, the
    two-tower pair) restored into a fresh model bitwise the live one,
    evicted rows included; DLRM and the unfolded DeepFM also against JAX's
    loop and `restore_delta` after the same steps, within the loops' own
    tolerance (rtol/atol 1e-4: f32 sums in another order).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embeddingtables_tpu.models import train as jax_train
from embeddingtables_tpu.utils import deltackpt as JDC
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.models import train as port_train
from embeddingtables_tpu_torch.utils import deltackpt as PDC
from _torch_persist import batches, fresh, loop_name, opts, pair
from _torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    """A tensor or JAX array as numpy, bf16 as f32."""
    if torch.is_tensor(x):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def test_tracker_observe_batch_matches_jax():
    rng = np.random.default_rng(0)
    offsets = (0, 13, 42, 49)
    cat = np.stack([rng.integers(0, v, (6, 3)) for v in (13, 29, 7)])
    cat[0, 1, 2] = cat[2, 0, 0] = -1
    j, p = (JDC.TouchedRowTracker(49), PDC.TouchedRowTracker(49))
    for t in (j, p):
        t.observe_batch(cat.astype(np.int32), offsets, pad_idx=-1)
    p.observe(torch.tensor([48, 0]))
    j.observe(np.array([48, 0]))
    np.testing.assert_array_equal(p.rows(), j.rows())
    assert p.rows().dtype == np.int32 and p.count() == j.count()
    p.clear()
    assert p.count() == 0


def _states(opt, data):
    """(jax state, port state) of `opt` for the numpy table `data`, moved
    off their initial values."""
    jopt, popt = opts(opt)
    jst = jopt.init(jnp.asarray(data))
    rng = np.random.default_rng(7)
    leaves = [np.asarray(x) + (rng.random(np.shape(x)).astype(np.float32)
                               if np.asarray(x).dtype == np.float32 else 3)
              for x in jst]
    jst = type(jst)(*[jnp.asarray(x) for x in leaves])
    pst = type(popt.init(torch.from_numpy(data)))(
        *[torch.from_numpy(np.array(x)) for x in leaves])
    return jst, pst


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam", "ftrl"])
def test_snapshot_matches_jax_and_apply_restores_bitwise(opt):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((40, 6)).astype(np.float32)
    jst, pst = _states(opt, data)
    rows = np.array([0, 3, 17, 39], np.int32)
    want = JDC.snapshot_delta(jnp.asarray(data), jst, rows)
    got = PDC.snapshot_delta(torch.from_numpy(data), pst, rows)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.array(want[k])).dtype, k
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    # Change the state everywhere, then set the snapshot back: the rows
    # return bitwise, the whole leaves (Adam's count) too.
    live = torch.from_numpy(data.copy())
    changed = type(pst)(*[t + 1 for t in pst])
    live += 1
    PDC.apply_delta(live, changed, got)
    np.testing.assert_array_equal(live.numpy()[rows], data[rows])
    for a, b in zip(changed, pst):
        if a.dim() and a.shape[0] == 40:
            assert torch.equal(a[rows], b[rows])
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delta_files_cross_between_the_packages(dtype, tmp_path):
    rng = np.random.default_rng(2)
    data32 = rng.standard_normal((30, 5)).astype(np.float32)
    jdata = jnp.asarray(data32, getattr(jnp, dtype))
    pdata = torch.from_numpy(data32).to(getattr(torch, dtype))
    jst, pst = _states("adagrad", data32)
    rows = np.array([1, 4, 29], np.int32)
    # JAX writes, the port reads and applies.
    JDC._atomic_savez(str(tmp_path / "j.npz"),
                      JDC.snapshot_delta(jdata, jst, rows))
    delta = PDC._load_npz(str(tmp_path / "j.npz"))
    assert delta["vals"].dtype == getattr(torch, dtype)
    target = torch.zeros_like(pdata)
    tstate = type(pst)(torch.zeros_like(pst.accum))
    PDC.apply_delta(target, tstate, delta)
    assert torch.equal(target[rows], pdata[rows])
    assert torch.equal(tstate.accum[rows], pst.accum[rows])
    # The port writes, JAX reads.
    PDC._atomic_savez(str(tmp_path / "p.npz"),
                      PDC.snapshot_delta(pdata, pst, rows))
    back = JDC._load_npz(str(tmp_path / "p.npz"))
    assert np.asarray(back["vals"]).dtype == jdata.dtype
    np.testing.assert_array_equal(_np(back["vals"]),
                                  _np(np.asarray(jdata)[rows]))
    np.testing.assert_array_equal(back["srow_0"], np.asarray(jst.accum)[rows])
    assert [f for f in os.listdir(tmp_path) if "tmp" in f] == []


def _listing(directory):
    return sorted(n for n in os.listdir(directory)
                  if n.startswith(("base_", "delta_", "rowlayout_")))


# Each scenario: (base_every, [(step, force_base_before)], reopen_after).
SCENARIOS = {
    "chain": (3, [(1, False), (2, False), (3, False)], None),
    "prune": (2, [(1, False), (2, False), (3, False), (4, False)], None),
    "force_base": (4, [(1, False), (2, False), (3, True), (4, False)], None),
    "reopen": (3, [(1, False), (2, False), (3, False), (4, False)], 2),
    # A reused directory whose run restarted its step count: the new base
    # prunes the old run's deltas past it.
    "stale": (3, [(5, False), (6, False), (1, False), (2, False)], 2),
    "empty": (3, [], None),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_managers_name_and_restore_as_jax(scenario, tmp_path):
    base_every, saves, reopen = SCENARIOS[scenario]
    rng = np.random.default_rng(3)
    data = rng.standard_normal((20, 4)).astype(np.float32)
    jst, pst = _states("adagrad", data)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm = JDC.DeltaCheckpointManager(jdir, base_every=base_every)
    pm = PDC.DeltaCheckpointManager(pdir, base_every=base_every)
    jd, pd = jnp.asarray(data), torch.from_numpy(data.copy())
    for k, (step, force) in enumerate(saves):
        if reopen is not None and k == reopen:
            jm = JDC.DeltaCheckpointManager(jdir, base_every=base_every)
            pm = PDC.DeltaCheckpointManager(pdir, base_every=base_every)
        if force:
            jm.force_base()
            pm.force_base()
        rows = np.unique(rng.integers(0, 20, 5)).astype(np.int32)
        upd = rng.standard_normal((rows.size, 4)).astype(np.float32)
        jd = jd.at[rows].add(upd)
        jst = type(jst)(jst.accum.at[rows].add(1.0))
        pd[rows] += torch.from_numpy(upd)
        pst.accum[rows] += 1.0
        jt, pt = JDC.TouchedRowTracker(20), PDC.TouchedRowTracker(20)
        jt.observe(rows)
        pt.observe(rows)
        jm.save(step, jd, jst, jt)
        pm.save(step, pd, pst, pt)
        assert _listing(pdir) == _listing(jdir)
        assert pm.latest_step() == jm.latest_step()
    want = jm.restore_latest(jnp.zeros_like(jd),
                             type(jst)(jnp.zeros_like(jst.accum)))
    tdata = torch.zeros_like(pd)
    tstate = type(pst)(torch.zeros_like(pst.accum))
    got = pm.restore_latest(tdata, tstate)
    if scenario == "empty":
        assert got is None and want is None
        assert pm.latest_step() is None
        return
    assert got[0] is tdata and got[1].accum is tstate.accum
    np.testing.assert_array_equal(tdata.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tstate.accum.numpy(),
                                  np.asarray(want[1].accum))
    assert torch.equal(tdata, pd) and torch.equal(tstate.accum, pst.accum)


def test_a_base_saved_in_a_sharded_layout_waits_for_item_i(tmp_path):
    """A base saved in the mod-row layout (item I-2b, ported): one part per
    rank, global row r at slot r // 2 of part r % 2. A flat model restores
    it by global row (`_restore_base_converted`) and a follower reads its
    table (`load_base_data`), bitwise."""
    from embeddingtables_tpu_torch.utils.checkpoint import save_checkpoint
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.standard_normal((7, 2)).astype(np.float32))
    accum = torch.from_numpy(rng.random(7).astype(np.float32))
    base = tmp_path / "base_1"
    base.mkdir()
    for r in range(2):
        mine = torch.cat([data[r::2], torch.zeros(4 - len(data[r::2]), 2)])
        acc = torch.cat([accum[r::2], torch.zeros(4 - len(accum[r::2]))])
        save_checkpoint(str(base / f"part_{r}"),
                        (mine, ett.SparseOptState(accum=acc)), parts=False)
    (base / "parts.json").write_text('{"parts": 2}')
    (tmp_path / "rowlayout_1.json").write_text(
        '{"kind": "mod", "n": 2, "rps": 4}')
    mgr = PDC.DeltaCheckpointManager(str(tmp_path))
    got = mgr.restore_latest(torch.zeros(7, 2),
                             ett.SparseOptState(accum=torch.zeros(7)))
    assert torch.equal(got[0], data) and torch.equal(got[1].accum, accum)
    assert torch.equal(PDC.load_base_data(str(tmp_path), 1, data), data)


def _state_leaves(family, m):
    if family == "two_tower":
        return [m.query_tables.data, *m.q_state, m.item_data, *m.i_state]
    leaves = [m.tables.data, *m.emb_state]
    if getattr(m, "fm_w", None) is not None:
        leaves += [m.fm_w.data, *m.fm_state]
    return leaves


def _managers(family, directory, base_every=3):
    if family == "two_tower":
        return (PDC.DeltaCheckpointManager(f"{directory}/q", base_every),
                PDC.DeltaCheckpointManager(f"{directory}/i", base_every))
    return PDC.DeltaCheckpointManager(directory, base_every)


@pytest.mark.parametrize("family", ["dlrm", "dcn", "deepfm", "deepfm_folded",
                                    "two_tower"])
def test_loop_delta_chain_restores_bitwise(family, tmp_path):
    (_, _, _), (cfg, opt, model) = pair(family)
    mgr = _managers(family, str(tmp_path))
    res = getattr(ett, loop_name(family))(
        cfg, batches(family), 5, sparse_opt=opt, model=model,
        delta_ckpt=mgr, delta_every=1, log_every=1, verbose=False,
        dense_lr=0.05)
    restored = ett.restore_delta(mgr, fresh(family))
    for got, want in zip(_state_leaves(family, restored),
                         _state_leaves(family, res.model)):
        assert torch.equal(got, want)
    assert port_train.restore_dlrm_delta is port_train.restore_delta
    assert port_train.restore_deepfm_delta is port_train.restore_delta
    assert port_train.restore_two_tower_delta is port_train.restore_delta


@pytest.mark.parametrize("family", ["dlrm", "deepfm"])
def test_loop_delta_chain_matches_jax(family, tmp_path):
    (jcfg, jopt, jm), (cfg, opt, pm) = pair(family)
    kw = dict(delta_every=1, log_every=1, verbose=False, dense_lr=0.05)
    jmgr = JDC.DeltaCheckpointManager(str(tmp_path / "jax"), base_every=3)
    pmgr = PDC.DeltaCheckpointManager(str(tmp_path / "port"), base_every=3)
    jres = getattr(jax_train, loop_name(family))(
        jcfg, batches(family), 4, sparse_opt=jopt, model=jm,
        delta_ckpt=jmgr, **kw)
    pres = getattr(ett, loop_name(family))(
        cfg, batches(family), 4, sparse_opt=opt, model=pm, delta_ckpt=pmgr,
        **kw)
    np.testing.assert_allclose(pres.losses, jres.losses, **TOL)
    assert _listing(str(tmp_path / "port")) == _listing(str(tmp_path / "jax"))
    want = jax_train.restore_delta(jmgr, pair(family, seed=9)[0][2])
    got = ett.restore_delta(pmgr, fresh(family))
    jleaves = [want.tables.data, *want.emb_state]
    if family == "deepfm":
        jleaves += [want.fm_w.data, *want.fm_state]
    for g, w in zip(_state_leaves(family, got), jleaves):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_eviction_marks_the_delta_tracker(tmp_path):
    (_, _, _), (cfg, opt, model) = pair("dlrm")
    mgr = PDC.DeltaCheckpointManager(str(tmp_path), base_every=8)
    evicted = []
    real = port_train._maybe_evict

    def spy(*a, **k):
        n = real(*a, **k)
        evicted.append(n)
        return n

    port_train._maybe_evict = spy
    try:
        res = ett.train_dlrm(cfg, batches("dlrm"), 6, sparse_opt=opt,
                             model=model, delta_ckpt=mgr, delta_every=3,
                             evict_every=2, evict_threshold=0.3,
                             freq_decay=0.5, log_every=1, verbose=False)
    finally:
        port_train._maybe_evict = real
    assert res.evicted_rows == sum(evicted) > 0
    restored = ett.restore_delta(mgr, fresh("dlrm"))
    assert torch.equal(restored.tables.data, res.model.tables.data)
    assert torch.equal(restored.emb_accum, res.model.emb_accum)


def test_delta_ckpt_without_delta_every_raises_as_jax():
    (_, _, _), (cfg, opt, model) = pair("dlrm")
    with pytest.raises(ValueError, match="delta_every"):
        ett.train_dlrm(cfg, batches("dlrm"), 1, model=model,
                       delta_ckpt=object())
