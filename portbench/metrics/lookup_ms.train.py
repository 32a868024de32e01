"""Device ms a training step spends in operations enqueued inside the
port's "step.lookup" span (the flat ids and `gather_rows` of the stacked
table; `spans.self_ms`), over the traced call's steps."""
from portbench import spans


def read(facts: dict):
    return spans.self_ms(facts, "step.lookup")
