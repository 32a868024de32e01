"""The port's checkpoints, divergence guard and telemetry
(`utils/checkpoint.py`, `utils/resilience.py`, `utils/telemetry.py`) and the
loops' `ckpt_manager` / `guard` against the JAX package's, on the CPU.

  - A checkpoint restores into its template in place (the same tensors),
    bitwise, for a model and for a `(data, state)` tuple; a shape, dtype or
    structure mismatch is refused; a failed save leaves no step behind.
  - `CheckpointManager` keeps the same steps as JAX's; `DivergenceGuard`
    makes JAX's decisions on the same loss streams; `resume_or_init` and
    `Telemetry` (phases, counters, callback order, `summary()` but for the
    times) give JAX's results.
  - The loops' `ckpt_manager` (every family) restores into a fresh model
    bitwise the live one; with a NaN batch and a guard, the DLRM loop rolls
    back once, as JAX's does, and its losses follow JAX's within the loops'
    tolerance (rtol/atol 1e-4); the loops' telemetry phases are JAX's.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

from embeddingtables_tpu.models import train as jax_train
from embeddingtables_tpu.utils import checkpoint as JC
from embeddingtables_tpu.utils import deltackpt as JDC
from embeddingtables_tpu.utils import resilience as JR
from embeddingtables_tpu.utils import telemetry as JT
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import utils
from embeddingtables_tpu_torch.utils import checkpoint as PC
from embeddingtables_tpu_torch.utils import telemetry as PT
from _torch_persist import batches, fresh, loop_name, pair
from _torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _tensors(model):
    return list(model.state_dict().values())


@pytest.mark.parametrize("family", ["dlrm", "deepfm", "two_tower"])
def test_checkpoint_restores_into_the_template_in_place(family, tmp_path):
    model = pair(family, "adam")[1][2]
    PC.save_checkpoint(str(tmp_path), model, step=3)
    target = fresh(family, "adam")
    held = _tensors(target)
    assert PC.restore_checkpoint(str(tmp_path / "3"), target) is target
    for a, b, c in zip(_tensors(target), _tensors(model), held):
        assert a.data_ptr() == c.data_ptr() and torch.equal(a, b)


def test_checkpoint_of_a_state_tuple_skips_zero_size_leaves(tmp_path):
    data = torch.randn((6, 3))
    tree = (data, ett.SparseSGD().init(data), ett.SparseLazyAdam().init(data))
    PC.save_checkpoint(str(tmp_path / "c"), tree)
    index = PC.read_index(str(tmp_path / "c"))
    assert index["count"] == 5
    assert [e["name"] for e in index["leaves"]] == ["0", "2.m", "2.v",
                                                    "2.count"]
    like = (torch.zeros_like(data), ett.SparseSGD().init(data),
            ett.SparseLazyAdam().init(data))
    PC.restore_checkpoint(str(tmp_path / "c"), like)
    assert torch.equal(like[0], data)


def test_restore_refuses_another_structure(tmp_path):
    data = torch.randn((6, 3))
    PC.save_checkpoint(str(tmp_path / "c"), (data, ett.SparseRowWiseAdaGrad()
                                             .init(data)))
    for bad in [(torch.zeros((6, 4)), torch.zeros(6)),
                (torch.zeros((6, 3), dtype=torch.bfloat16), torch.zeros(6)),
                (torch.zeros((6, 3)),),
                {"0": torch.zeros((6, 3)), "1": torch.zeros(6)}]:
        with pytest.raises(ValueError):
            PC.restore_checkpoint(str(tmp_path / "c"), bad)


def test_a_failed_save_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    mgr = PC.CheckpointManager(str(tmp_path))
    model = pair("dlrm")[1][2]
    mgr.save(1, model)
    real = torch.save
    calls = []

    def failing(obj, f, *a, **k):
        calls.append(f)
        if len(calls) % 3 == 2:         # the second leaf of each save
            raise OSError("disk full")
        return real(obj, f, *a, **k)

    monkeypatch.setattr(torch, "save", failing)
    with pytest.raises(OSError):
        mgr.save(1, fresh("dlrm"))
    with pytest.raises(OSError):
        mgr.save(2, fresh("dlrm"))
    monkeypatch.setattr(torch, "save", real)
    assert sorted(os.listdir(tmp_path)) == ["1"] and mgr.latest_step() == 1
    target = fresh("dlrm")
    mgr.restore_latest(target)
    for a, b in zip(_tensors(target), _tensors(model)):
        assert torch.equal(a, b)


def test_manager_rotation_matches_jax(tmp_path):
    (_, _, jm), (_, _, pm) = pair("dlrm")
    jmgr = JC.CheckpointManager(str(tmp_path / "jax"), max_to_keep=2)
    pmgr = PC.CheckpointManager(str(tmp_path / "port"), max_to_keep=2)
    assert pmgr.latest_step() is jmgr.latest_step() is None
    assert pmgr.restore_latest(pm) is jmgr.restore_latest(jm) is None
    for step in (2, 4, 7, 9):
        jmgr.save(step, jm)
        pmgr.save(step, pm)
        assert pmgr._steps() == jmgr._steps()
        assert pmgr.latest_step() == jmgr.latest_step()
    assert pmgr._steps() == [7, 9]


class _Recorder:
    """A stand-in checkpoint manager that counts restores."""

    def __init__(self, latest):
        self.latest, self.restores = latest, 0

    def latest_step(self):
        return self.latest

    def restore_latest(self, model):
        self.restores += 1
        return model


STREAMS = {
    "nan": [0.7, 0.69, float("nan"), 0.68, 0.67],
    "spike": [1.0, 1.0, 1.0, 50.0, 1.0, 0.9],
    "inf_patience": [0.5, float("inf"), 0.5, float("inf"), float("inf"), 0.4],
    "no_checkpoint": [0.3, float("nan"), 0.3],
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_guard_decisions_match_jax(stream):
    kw = dict(patience=2) if stream == "inf_patience" else {}
    latest = None if stream == "no_checkpoint" else 4
    jrec, prec = _Recorder(latest), _Recorder(latest)
    jg = JR.DivergenceGuard(jrec, **kw)
    pg = utils.DivergenceGuard(prec, **kw)
    model = object()
    for loss in STREAMS[stream]:
        jm, jrolled = jg.observe(loss, model)
        pm, prolled = pg.observe(loss, model)
        assert (prolled, pm) == (jrolled, jm)
        assert pg._mean == jg._mean and pg._bad == jg._bad
    assert pg.rollbacks == jg.rollbacks > 0
    assert prec.restores == jrec.restores


def test_resume_or_init_matches_jax(tmp_path):
    (_, _, jm), (_, _, pm) = pair("dlrm")
    jmgr = JC.CheckpointManager(str(tmp_path / "jax"))
    pmgr = PC.CheckpointManager(str(tmp_path / "port"))
    jgot, jstep = JR.resume_or_init(jmgr, lambda: jm)
    pgot, pstep = utils.resume_or_init(pmgr, lambda: pm)
    assert (pstep, pgot) == (jstep, pm) and jgot is jm
    jmgr.save(5, jm)
    pmgr.save(5, pm)
    jgot, jstep = JR.resume_or_init(jmgr, lambda: pair("dlrm", seed=9)[0][2])
    pgot, pstep = utils.resume_or_init(pmgr, lambda: fresh("dlrm"))
    assert pstep == jstep == 5
    np.testing.assert_array_equal(pgot.tables.data.numpy(),
                                  np.asarray(jgot.tables.data))
    for a, b in zip(_tensors(pgot), _tensors(pm)):
        assert torch.equal(a, b)


def _drive_telemetry(tel_mod):
    tel = tel_mod.Telemetry()
    events = []
    tel.on_phase(lambda name, ev: events.append((name, ev)))
    tel.count("rows", 3)
    tel.count("rows")
    tel.record_bytes("gather", 1024)
    with tel.phase("gather", nbytes=2048):
        with tel.phase("inner", sync=True):
            pass
    with pytest.raises(RuntimeError):
        with tel.phase("gather"):
            raise RuntimeError("in the block")
    old = tel_mod.set_telemetry(tel)
    try:
        assert tel_mod.get_telemetry() is tel
        with tel_mod.phase("module_level"):
            pass
    finally:
        tel_mod.set_telemetry(old)
    return tel, events


def test_telemetry_matches_jax():
    jt, jev = _drive_telemetry(JT)
    pt, pev = _drive_telemetry(PT)
    assert pev == jev
    assert dict(pt.counters) == dict(jt.counters)
    assert {k: (v.count, v.bytes) for k, v in pt.phases.items()} == \
        {k: (v.count, v.bytes) for k, v in jt.phases.items()}

    def masked(text):
        return re.sub(r"[0-9.]+ (ms|GB/s)", r"_ \1", text)

    assert masked(pt.summary()) == masked(jt.summary())
    pt.reset()
    assert not pt.phases and not pt.counters


def test_trace_profile_writes_a_trace_or_counts_why_not(tmp_path,
                                                        monkeypatch):
    tel = PT.Telemetry()
    old = PT.set_telemetry(tel)
    try:
        with PT.trace_profile(str(tmp_path / "trace")):
            torch.randn(8, 8) @ torch.randn(8, 8)
        assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
        import torch.profiler as prof

        def refuse(*a, **k):
            raise RuntimeError("no profiler here")

        monkeypatch.setattr(prof, "profile", refuse)
        ran = []
        with PT.trace_profile(str(tmp_path / "none")):
            ran.append(1)
        assert ran == [1] and tel.counters["trace_profile.unsupported"] == 1
        assert not os.path.exists(tmp_path / "none")
    finally:
        PT.set_telemetry(old)


@pytest.mark.parametrize("family", ["dlrm", "dcn", "deepfm_folded",
                                    "two_tower"])
def test_loop_checkpoints_restore_bitwise(family, tmp_path):
    (_, _, _), (cfg, opt, model) = pair(family, "adam")
    mgr = PC.CheckpointManager(str(tmp_path), max_to_keep=2)
    res = getattr(ett, loop_name(family))(
        cfg, batches(family), 5, sparse_opt=opt, model=model,
        ckpt_manager=mgr, ckpt_every=2, log_every=1, verbose=False,
        dense_lr=0.05)
    assert res.model is model and sorted(os.listdir(tmp_path)) == ["2", "4"]
    # The checkpoint at step 4 is the model of a 4-step run, bitwise.
    target = fresh(family, "adam")
    mgr.restore(4, target)
    res_4 = getattr(ett, loop_name(family))(
        cfg, batches(family), 4, sparse_opt=opt,
        model=pair(family, "adam")[1][2], log_every=0, verbose=False,
        dense_lr=0.05)
    for a, b in zip(_tensors(target), _tensors(res_4.model)):
        assert torch.equal(a, b)


def test_guarded_loop_rolls_back_as_jax(tmp_path):
    (jcfg, jopt, jm), (cfg, opt, pm) = pair("dlrm")
    stream = [b for b, _ in zip(batches("dlrm"), range(5))]
    poisoned = dict(stream[0], dense=np.full_like(stream[0]["dense"],
                                                  np.nan))
    stream = stream[:4] + [poisoned, stream[4]]
    jmgr = JC.CheckpointManager(str(tmp_path / "jax"))
    pmgr = PC.CheckpointManager(str(tmp_path / "port"))
    jdelta = JDC.DeltaCheckpointManager(str(tmp_path / "jd"), base_every=4)
    pdelta = utils.DeltaCheckpointManager(str(tmp_path / "pd"), base_every=4)
    jguard = JR.DivergenceGuard(jmgr)
    rolled_to = []

    class Checked(utils.DivergenceGuard):
        def observe(self, loss, model):
            model, rolled = super().observe(loss, model)
            if rolled:
                want = fresh("dlrm")
                self.ckpt.restore_latest(want)
                rolled_to.append(all(
                    torch.equal(a, b) for a, b in
                    zip(_tensors(model), _tensors(want))))
            return model, rolled

    pguard = Checked(pmgr)
    kw = dict(ckpt_every=2, log_every=1, delta_every=2, verbose=False,
              dense_lr=0.05)
    jres = jax_train.train_dlrm(jcfg, iter(stream), 6, sparse_opt=jopt,
                                model=jm, ckpt_manager=jmgr, guard=jguard,
                                delta_ckpt=jdelta, **kw)
    pres = ett.train_dlrm(cfg, iter(stream), 6, sparse_opt=opt, model=pm,
                          ckpt_manager=pmgr, guard=pguard, delta_ckpt=pdelta,
                          **kw)
    assert pguard.rollbacks == jguard.rollbacks == 1 and rolled_to == [True]
    assert math.isnan(pres.losses[4]) and math.isnan(jres.losses[4])
    keep = [i for i in range(6) if i != 4]
    np.testing.assert_allclose(np.array(pres.losses)[keep],
                               np.array(jres.losses)[keep], **TOL)
    # The rollback made the next delta save a base, in both packages.
    names = sorted(n for n in os.listdir(tmp_path / "pd")
                   if n.startswith(("base_", "delta_")))
    assert names == ["base_6"] == sorted(
        n for n in os.listdir(tmp_path / "jd")
        if n.startswith(("base_", "delta_")))
    np.testing.assert_allclose(pres.model.tables.data.numpy(),
                               np.asarray(jres.model.tables.data), **TOL)


def test_loop_telemetry_phases_match_jax(tmp_path):
    (jcfg, jopt, jm), (cfg, opt, pm) = pair("dcn")
    evals = [b for b, _ in zip(batches("dcn", seed=11), range(2))]
    counts = []
    for train, tel_mod, model, o, c, mgr in (
            (jax_train.train_dcn, JT, jm, jopt, jcfg,
             JC.CheckpointManager(str(tmp_path / "j"))),
            (ett.train_dcn, PT, pm, opt, cfg,
             PC.CheckpointManager(str(tmp_path / "p")))):
        tel = tel_mod.Telemetry()
        old = tel_mod.set_telemetry(tel)
        try:
            train(c, batches("dcn"), 4, sparse_opt=o, model=model,
                  ckpt_manager=mgr, ckpt_every=2, eval_every=2,
                  eval_batches=evals, log_every=2, verbose=False)
        finally:
            tel_mod.set_telemetry(old)
        counts.append({k: v.count for k, v in tel.phases.items()})
    # The port's step also opens a span at each layer (the JAX package,
    # whose step is one jitted program, has none): once a step each.
    layers = {k: counts[1].pop(k) for k in list(counts[1])
              if k.startswith(("step.", "update."))}
    assert counts[1] == counts[0] == {"data": 4, "step": 4, "eval": 2,
                                      "checkpoint": 2}
    assert layers == dict.fromkeys(
        ("step.lookup", "step.forward", "step.backward", "step.sparse_update",
         "step.dense_update", "update.sort", "update.permute",
         "update.scatter"), 4)
