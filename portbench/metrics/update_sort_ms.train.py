"""Device ms a training step spends in "update.sort" (the stable
`torch.sort` of the update's rows in `ops.cuda.scatter.scatter_update`),
over the traced call's steps."""
from portbench import spans


def read(facts: dict):
    return spans.self_ms(facts, "update.sort")
