"""Device ms a training step spends in "update.permute" (`gather_rows` of
the update's values into row order in `scatter_update`), over the traced
call's steps."""
from portbench import spans


def read(facts: dict):
    return spans.self_ms(facts, "update.permute")
