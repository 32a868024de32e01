"""The train step's layer spans (telemetry phases "step.*" and "update.*"):
how often each opens, how they nest, and that watching them changes no
bit of the training. CPU only, small models; the port alone."""
import pytest
import torch

import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.data import SyntheticCriteo
from embeddingtables_tpu_torch.utils import telemetry as PT
from _torch_threads import _one_torch_thread  # noqa: F401

VOCABS = (13, 29, 7)
STEPS = 3
STEP_SPANS = ("step.lookup", "step.forward", "step.backward",
              "step.sparse_update", "step.dense_update")
UPDATE_SPANS = ("update.sort", "update.permute", "update.scatter")
# A microbatched step opens these once a slice.
PER_SLICE = ("step.lookup", "step.forward", "step.backward")


def _model(family, opt):
    common = dict(vocab_sizes=VOCABS, num_dense=3, dim=8,
                  compute_dtype=torch.float32)
    if family == "dlrm":
        cfg = ett.DLRMConfig(bottom_mlp=(16, 8), top_mlp=(16, 1), **common)
        return cfg, ett.init_dlrm(cfg, device="cpu", sparse_opt=opt)
    cfg = ett.DCNConfig(deep_mlp=(16, 8), num_cross=1, **common)
    return cfg, ett.init_dcn(cfg, device="cpu", sparse_opt=opt)


OPTS = {"dlrm": lambda: ett.SparseSGD(0.1),
        "dcn": lambda: ett.SparseRowWiseAdaGrad(0.1, method="indexer")}


def _train(family, microbatch=None, watch=False):
    """(losses, table, {phase: count}, [(phase, event)] or None) of a
    3-step run of `family`'s loop under its own telemetry."""
    opt = OPTS[family]()
    cfg, model = _model(family, opt)
    tel = PT.Telemetry()
    events = [] if watch else None
    if watch:
        tel.on_phase(lambda name, ev: events.append((name, ev)))
    old = PT.set_telemetry(tel)
    try:
        res = getattr(ett, f"train_{family}")(
            cfg, SyntheticCriteo(vocab_sizes=VOCABS, num_dense=3,
                                 batch_size=16, seed=4).batches(),
            STEPS, sparse_opt=opt, model=model, dense_lr=0.05,
            microbatch=microbatch, log_every=1, verbose=False, device="cpu")
    finally:
        PT.set_telemetry(old)
    return (list(res.losses), res.model.tables.data.clone(),
            {k: v.count for k, v in tel.phases.items()}, events)


@pytest.mark.parametrize("family", ["dlrm", "dcn"])
@pytest.mark.parametrize("microbatch", [None, 2])
def test_each_span_opens_once_a_step(family, microbatch):
    _, _, counts, _ = _train(family, microbatch)
    k = microbatch or 1
    want = {s: STEPS * (k if s in PER_SLICE else 1) for s in STEP_SPANS}
    want.update({s: STEPS for s in UPDATE_SPANS})
    assert {n: c for n, c in counts.items()
            if n.startswith(("step.", "update."))} == want
    assert counts["step"] == STEPS


def _stacks(events):
    """For each span opened, the names of the spans open around it."""
    out, stack = [], []
    for name, ev in events:
        if ev == "start":
            out.append((name, tuple(stack)))
            stack.append(name)
        else:
            assert stack.pop() == name      # closed in the order opened
    assert not stack
    return out


@pytest.mark.parametrize("family", ["dlrm", "dcn"])
def test_spans_nest_inside_the_step(family):
    _, _, _, events = _train(family, watch=True)
    stacks = _stacks(events)
    for name, around in stacks:
        if name.startswith("step."):
            assert around == ("step",), (name, around)
        if name.startswith("update."):
            assert around == ("step", "step.sparse_update"), (name, around)
    order = [n for n, _ in stacks if n.startswith(("step.", "update."))]
    assert order == [*STEP_SPANS[:4], *UPDATE_SPANS,
                     STEP_SPANS[4]] * STEPS


@pytest.mark.parametrize("family", ["dlrm", "dcn"])
def test_watching_the_spans_changes_no_bit(family):
    losses, table, _, _ = _train(family)
    w_losses, w_table, _, events = _train(family, watch=True)
    assert events and w_losses == losses
    assert torch.equal(w_table, table)
