"""The training window: a traced run profiles a call of the mix's
`traced_steps` (at most `steps_per_call`), and the rate counts every step
the window made, the traced call's too."""
import torch

from portbench import run, spec
from portbench.tests import tiny


class _Tracer:
    """Stands in for `trace.Tracer`: profiles nothing."""
    trace = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _window(traffic: dict, tracer):
    c = tiny.cell("dlrm.train.zipf")
    c.traffic = {**c.traffic, **traffic}
    kind = spec.load_module("kinds", c.traffic["kind"])
    runner = kind.Runner(c, 2**31 + 11, torch.device("cpu"), run.log)
    runner.setup()
    return runner.window(0.2, tracer)


def test_traced_call_takes_the_mixs_traced_steps():
    w = _window({"steps_per_call": 4, "traced_steps": 2}, _Tracer())
    facts = w["facts"]
    assert len(facts["traced_batches"]) == 2
    assert facts["steps"] == w["attempted"]
    assert (facts["steps"] - 2) % 4 == 0 and facts["steps"] >= 6
    assert w["e2e"]["train_examples_per_s"] == \
        facts["examples"] / facts["window_s"]


def test_traced_steps_never_exceed_a_call():
    w = _window({"steps_per_call": 3, "traced_steps": 8}, _Tracer())
    assert len(w["facts"]["traced_batches"]) == 3
    assert w["facts"]["steps"] % 3 == 0
