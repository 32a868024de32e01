"""Device ms a training step spends in operations enqueued inside
"step.sparse_update" and not inside an "update.*" span in it: the lazy
update's casts and the row resolution of `sparse_opt.apply` (self time),
over the traced call's steps."""
from portbench import spans


def read(facts: dict):
    return spans.self_ms(facts, "step.sparse_update")
