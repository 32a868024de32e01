"""Device ms a training step spends in "step.dense_update" (the towers'
SGD step, `apply_dense_tx`), over the traced call's steps."""
from portbench import spans


def read(facts: dict):
    return spans.self_ms(facts, "step.dense_update")
