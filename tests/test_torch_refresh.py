"""The port's refreshable serving (`serving.make_refreshable_service`,
`make_refreshable_dlrm_service`) and `utils.DeltaFollower` against the JAX
package's, on the CPU.

  - A follower tracks a trainer's chain across two loop runs with JAX's
    poll counts; its table is bitwise the trainer's and within the loops'
    tolerance of JAX's (rtol/atol 1e-4: f32 sums in another order). It
    never writes a tensor it has handed out, and skips what a base commit
    pruned.
  - The DLRM, folded DeepFM and DCN services: after a poll and
    `swap_tables`, scores bitwise the trained model's eval step, within
    1e-4 of JAX's refreshed service; `swap` serves another model; the
    trainer's own model is never written; every flushed batch reads one
    table across repeated swaps; the two-tower model raises JAX's
    `TypeError`.
"""
import threading

import numpy as np
import pytest
import torch


from embeddingtables_tpu import serving as jax_serving
from embeddingtables_tpu.models import train as jax_train
from embeddingtables_tpu.utils import deltackpt as JDC
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import serving
from embeddingtables_tpu_torch.utils import deltackpt as PDC
from _torch_persist import VOCABS, batches, loop_name, pair
from _torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _request(seed=3, b=5):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(b, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, v, b).astype(np.int32) for v in VOCABS])
    return dense, cat


def test_follower_tracks_the_chain_as_jax(tmp_path):
    (jcfg, jopt, jm), (cfg, opt, pm) = pair("dlrm")
    kw = dict(dense_lr=0.0, log_every=0, verbose=False, delta_every=2)
    jmgr = JDC.DeltaCheckpointManager(str(tmp_path / "jax"), base_every=3)
    pmgr = PDC.DeltaCheckpointManager(str(tmp_path / "port"), base_every=3)
    jf = JDC.DeltaFollower(str(tmp_path / "jax"), jm.tables.data)
    pf = PDC.DeltaFollower(str(tmp_path / "port"), pm.tables.data.clone())
    assert pf.poll() == jf.poll() == 0
    jres = jax_train.train_dlrm(jcfg, batches("dlrm"), 4, sparse_opt=jopt,
                                model=jm, delta_ckpt=jmgr, **kw)
    pres = ett.train_dlrm(cfg, batches("dlrm"), 4, sparse_opt=opt, model=pm,
                          delta_ckpt=pmgr, **kw)
    assert pf.poll() == jf.poll() == 2          # base_2 + delta_4
    assert torch.equal(pf.data, pres.model.tables.data)
    np.testing.assert_allclose(pf.data.numpy(), np.asarray(jf.data), **TOL)
    # The same chain continued: the cadence's next base, then a delta.
    jres = jax_train.train_dlrm(jcfg, batches("dlrm", seed=8), 4,
                                sparse_opt=jopt, model=jres.model,
                                delta_ckpt=jmgr, **kw)
    pres = ett.train_dlrm(cfg, batches("dlrm", seed=8), 4, sparse_opt=opt,
                          model=pres.model, delta_ckpt=pmgr, **kw)
    assert pf.poll() == jf.poll()
    assert pf.poll() == jf.poll() == 0
    assert torch.equal(pf.data, pres.model.tables.data)
    np.testing.assert_allclose(pf.data.numpy(), np.asarray(jf.data), **TOL)


def test_follower_never_writes_a_tensor_it_handed_out(tmp_path):
    (_, _, _), (cfg, opt, pm) = pair("dlrm")
    mgr = PDC.DeltaCheckpointManager(str(tmp_path), base_every=8)
    follower = PDC.DeltaFollower(str(tmp_path), pm.tables.data.clone())
    ett.train_dlrm(cfg, batches("dlrm"), 2, sparse_opt=opt, model=pm,
                   delta_ckpt=mgr, delta_every=1, log_every=0,
                   verbose=False)
    assert follower.poll() == 2
    handed = follower.data
    kept = handed.clone()
    for step in (3, 4):                 # two more deltas of the chain
        rows = np.array([step, 20 + step], np.int32)
        pm.tables.data[rows] += 1.0
        tracker = PDC.TouchedRowTracker(pm.tables.data.shape[0])
        tracker.observe(rows)
        mgr.save(step, pm.tables.data, pm.emb_state, tracker)
    assert follower.poll() == 2
    assert follower.data is not handed and torch.equal(handed, kept)
    assert torch.equal(follower.data, pm.tables.data)


def test_follower_resyncs_after_files_pruned_mid_poll(tmp_path, monkeypatch):
    (_, _, _), (cfg, opt, pm) = pair("dlrm")
    mgr = PDC.DeltaCheckpointManager(str(tmp_path), base_every=8)
    ett.train_dlrm(cfg, batches("dlrm"), 3, sparse_opt=opt, model=pm,
                   delta_ckpt=mgr, delta_every=1, log_every=0,
                   verbose=False)
    follower = PDC.DeltaFollower(str(tmp_path), pm.tables.data.clone())
    real = PDC.load_base_data

    def pruned(*a, **k):
        raise FileNotFoundError("pruned by a base commit")

    monkeypatch.setattr(PDC, "load_base_data", pruned)
    assert follower.poll() == 0
    monkeypatch.setattr(PDC, "load_base_data", real)
    real_load = PDC._load_npz

    def gone(path):
        if path.endswith("delta_2.npz"):
            raise FileNotFoundError(path)
        return real_load(path)

    monkeypatch.setattr(PDC, "_load_npz", gone)
    assert follower.poll() == 2                 # base_1, delta_3
    monkeypatch.setattr(PDC, "_load_npz", real_load)
    assert follower.poll() == 0


def _served_pair(family, tmp_path):
    """The JAX and port loops trained 4 steps with frozen towers, each
    writing a delta chain; returns the JAX and port (trained model, a copy
    of the model before training, chain directory)."""
    (jcfg, jopt, jm), (cfg, opt, pm) = pair(family)
    # JAX's loop donates its model's buffers: the services get copies.
    (_, _, jbefore), (_, _, before) = pair(family)
    kw = dict(dense_lr=0.0, log_every=0, verbose=False, delta_every=2)
    jmgr = JDC.DeltaCheckpointManager(str(tmp_path / "jax"), base_every=4)
    pmgr = PDC.DeltaCheckpointManager(str(tmp_path / "port"), base_every=4)
    jres = getattr(jax_train, loop_name(family))(
        jcfg, batches(family), 4, sparse_opt=jopt, model=jm,
        delta_ckpt=jmgr, **kw)
    pres = getattr(ett, loop_name(family))(
        cfg, batches(family), 4, sparse_opt=opt, model=pm, delta_ckpt=pmgr,
        **kw)
    return (jbefore, jres.model), (before, pres.model)


@pytest.mark.parametrize("family", ["dlrm", "deepfm_folded", "dcn"])
def test_refreshed_service_serves_the_trained_rows(family, tmp_path):
    (jm0, jtrained), (pm0, ptrained) = _served_pair(family, tmp_path)
    dense, cat = _request()
    jsvc, _ = jax_serving.make_refreshable_service(jm0, max_batch=16,
                                                   max_latency_ms=1.0)
    psvc, _ = serving.make_refreshable_service(pm0, max_batch=16,
                                               max_latency_ms=1.0)
    try:
        before = psvc.predict(dense, cat, timeout=30)
        jf = JDC.DeltaFollower(str(tmp_path / "jax"), jm0.tables.data)
        pf = PDC.DeltaFollower(str(tmp_path / "port"), pm0.tables.data)
        assert pf.poll() == jf.poll() == 2
        jsvc.swap_tables(jf.data)
        psvc.swap_tables(pf.data)
        after = psvc.predict(dense, cat, timeout=30)
        jafter = np.asarray(jsvc.predict(dense, cat, timeout=30))
    finally:
        psvc.stop()
        jsvc.stop()
    step = serving._ctr_eval_step_for(ptrained)
    want = step(ptrained, torch.from_numpy(dense),
                torch.from_numpy(cat)).numpy()
    np.testing.assert_array_equal(after, want)
    np.testing.assert_allclose(after, jafter, **TOL)
    assert not np.array_equal(after, before)


def test_swap_tables_leaves_the_trainer_model_alone():
    (_, _, _), (cfg, opt, model) = pair("dlrm")
    kept = model.tables.data.clone()
    svc, swap = ett.make_refreshable_dlrm_service(model, max_batch=16)
    try:
        dense, cat = _request()
        old = svc.predict(dense, cat, timeout=30)
        svc.swap_tables(torch.zeros_like(kept))
        zeroed = svc.predict(dense, cat, timeout=30)
        assert model.tables.data is not None and torch.equal(
            model.tables.data, kept)
        other = pair("dlrm", seed=9)[1][2]
        swap(other)
        theirs = svc.predict(dense, cat, timeout=30)
    finally:
        svc.stop()
    want = ett.make_eval_step(cfg)(model, torch.from_numpy(dense),
                                   torch.from_numpy(cat)).numpy()
    np.testing.assert_array_equal(old, want)
    assert not np.array_equal(zeroed, old)
    np.testing.assert_array_equal(theirs, ett.make_eval_step(cfg)(
        other, torch.from_numpy(dense), torch.from_numpy(cat)).numpy())


def test_every_batch_reads_one_table_across_swaps():
    (_, _, _), (cfg, opt, model) = pair("dlrm")
    tables = [model.tables.data, model.tables.data * 2, -model.tables.data]
    svc, _ = ett.make_refreshable_dlrm_service(model, max_batch=32,
                                               max_latency_ms=1.0)
    seen, inner = [], svc._predict

    def record(dense, cat):
        out = inner(dense, cat)
        seen.append((dense, cat, out))
        return out

    svc._predict = record
    stop = threading.Event()

    def swapper():
        k = 0
        while not stop.is_set():
            k += 1
            svc.swap_tables(tables[k % 3])

    t = threading.Thread(target=swapper)
    t.start()
    try:
        futures = [svc.submit(*_request(seed, b=1 + seed % 7))
                   for seed in range(60)]
        [f.result(timeout=60) for f in futures]
    finally:
        stop.set()
        t.join()
        svc.stop()
    step = ett.make_eval_step(cfg)
    for dense, cat, out in seen:
        refs = []
        for data in tables:
            m = serving._with_tables(model, data)
            refs.append(step(m, torch.from_numpy(dense),
                             torch.from_numpy(cat)).numpy())
        assert any(np.array_equal(out, r) for r in refs)


def test_two_tower_is_refused_as_jax_refuses_it():
    (_, _, jm), (_, _, pm) = pair("two_tower")
    with pytest.raises(TypeError, match="CTR") as theirs:
        jax_serving.make_refreshable_service(jm)
    with pytest.raises(TypeError, match="CTR") as ours:
        ett.make_refreshable_service(pm)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(TypeError, match="CTR"):
        serving.make_refreshable_dlrm_service(object())
