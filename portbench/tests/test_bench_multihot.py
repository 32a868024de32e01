"""The multi-hot training cell at a size a CPU test holds: its generator,
its facts and counters, `correct` true for a sound run and false for each
fault with the cell's own limits (as `test_bench_checks.py` holds the
one-hot cells), and the control read well above the sound run."""
import numpy as np
import pytest
import torch

from portbench import check, run, spec
from portbench.kinds import train_multihot

NAME = "dlrmv2.train.multihot"
SEED = 2**31 + 7


def tiny_cell():
    c = spec.load_cell(NAME)
    cfg = dict(c.config)
    cfg["vocab_sizes"] = [max(3, v // 20000) for v in cfg["vocab_sizes"]]
    cfg.update(dim=16, cross_rank=32, deep_mlp=[64, 32], dense_mlp=[32, 16])
    c.config = cfg
    c.traffic = {**c.traffic, "batch": 1024, "steps_per_call": 4,
                 "batches": 4}
    return c


def _run(c):
    return run.run_cell(c, SEED, 0.5, False, torch.device("cpu"))


def _judge(c, numbers):
    for k in c.not_compared:
        numbers.pop(k, None)
    return check.judge(numbers, c.limits)[0]


def test_bags_are_fixed_by_their_anchor_and_by_the_seed():
    c = tiny_cell()
    a = train_multihot.multihot_batches(c.config, c.traffic, 5, "cpu")
    b = train_multihot.multihot_batches(c.config, c.traffic, 5, "cpu")
    other = train_multihot.multihot_batches(c.config, c.traffic, 6, "cpu")
    widths = c.config["bag_sizes"]
    starts = np.cumsum([0] + widths)
    cat = np.concatenate([x["cat"] for x in a], axis=1)
    assert cat.shape == (sum(widths), 4 * 1024) and cat.dtype == np.int32
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["cat"], other[0]["cat"])
    for t, (v, w) in enumerate(zip(c.config["vocab_sizes"], widths)):
        bag = cat[starts[t]:starts[t + 1]]
        assert 0 <= bag.min() and bag.max() < v
        # one bag an anchor
        seen = {}
        for col in bag.T:
            assert seen.setdefault(int(col[0]), tuple(col)) == tuple(col)


def test_sound_run_is_correct_and_counts_its_ids():
    c = tiny_cell()
    kind = spec.load_module("kinds", c.traffic["kind"])
    r = kind.Runner(c, SEED, torch.device("cpu"), lambda m: None)
    r.setup()
    w = r.window(0.2)
    s, t = sum(c.config["bag_sizes"]), len(c.config["vocab_sizes"])
    assert w["facts"]["n_ids"] == s * 1024
    assert w["facts"]["n_bags"] == t * 1024
    assert w["facts"]["counters"] == {"lookup.ids": s * 1024,
                                      "lookup.bags": t * 1024}
    r.release()
    sound, control = r.numbers(), r.control_numbers()
    assert _judge(c, dict(sound))
    # The limits are set at the published widths, where the control's
    # change_gap reads 47x the sound runs' largest (PERF.md); at this size
    # it reads about 4x, under the limit, so the control is held to the
    # sound run's readings here.
    for k in ("grad_gap", "change_gap"):
        assert control[k] > 3 * sound[k]
    assert not _judge(c, r.fault_numbers()["half_batch"])


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_faults_fail(fault, monkeypatch):
    from embeddingtables_tpu_torch import optim
    from embeddingtables_tpu_torch.models import dcn
    if fault == "unchanged":
        monkeypatch.setattr(optim.SparseRowWiseAdaGrad, "apply",
                            lambda self, data, upd, state, **kw: (data, state))
        monkeypatch.setattr(dcn, "apply_dense_tx", lambda *a, **k: None)
    else:
        full = dcn.bce_loss

        def half(logits, labels):
            n = logits.shape[0] // 2
            return full(logits[:n], labels[:n])
        monkeypatch.setattr(dcn, "bce_loss", half)
    assert not _run(tiny_cell())["correct"]
