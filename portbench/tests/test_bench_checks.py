"""`correct` comes out false for the control and for each fault a cell can
have, at a size a test run holds, with the cell's own limits.

The control is the plain reference in the next precision below the
configuration's (fp8 tower products, bf16 tables), in the program's place.
The faults are planted in the port underneath a whole run whose look for a
card is skipped: a step that returns its state unchanged; half of the batch
left out, the mean taken over the rest. The one-card cells have no
exchange between chips to leave out (`test_bench_mesh.py` leaves it out of
the four-card path)."""
import pytest
import torch

from portbench import check, spec
from portbench.tests import tiny

TRAIN = ["dlrm.train.zipf", "dcn.train.zipf"]


def _judge(c, numbers):
    for k in c.not_compared:
        numbers.pop(k, None)
    return check.judge(numbers, c.limits)[0]


@pytest.mark.parametrize("name", TRAIN)
def test_program_passes_and_control_fails(name):
    c = tiny.cell(name)
    kind = spec.load_module("kinds", c.traffic["kind"])
    for seed in (11, 2**31 + 12):
        r = kind.Runner(c, seed, torch.device("cpu"), lambda m: None)
        r.setup()
        r.release()
        assert _judge(c, r.numbers())
        assert not _judge(c, r.control_numbers())


@pytest.mark.parametrize("name", TRAIN)
def test_sound_run_is_correct(name):
    assert tiny.run_tiny(tiny.cell(name))["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_fails(name, monkeypatch):
    from embeddingtables_tpu_torch import optim
    monkeypatch.setattr(optim.SparseSGD, "apply",
                        lambda self, data, upd, state, **kw: (data, state))
    monkeypatch.setattr(optim.SparseRowWiseAdaGrad, "apply",
                        lambda self, data, upd, state, **kw: (data, state))
    for mod in ("dlrm", "dcn"):
        monkeypatch.setattr(f"embeddingtables_tpu_torch.models.{mod}."
                            "apply_dense_tx", lambda *a, **k: None)
    assert not tiny.run_tiny(tiny.cell(name))["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_fails(name, monkeypatch):
    from embeddingtables_tpu_torch.models import dlrm
    full = dlrm.bce_loss

    def half(logits, labels):
        n = logits.shape[0] // 2
        return full(logits[:n], labels[:n])

    for mod in ("dlrm", "dcn"):
        monkeypatch.setattr(f"embeddingtables_tpu_torch.models.{mod}."
                            "bce_loss", half)
    assert not tiny.run_tiny(tiny.cell(name))["correct"]
