"""Device ms a step spends in NCCL's kernels (the gather exchange's
all-gathers and reduce-scatter, the towers' all-reduce) on rank 0, over
the traced call's steps."""
from portbench import readings


def read(facts: dict):
    steps = len(facts.get("traced_batches", []))
    tr = facts.get("trace")
    if not steps or tr is None:
        return None
    ks = [k for k in tr.kernels() if "nccl" in k.name.lower()]
    return 1e3 * readings.seconds(ks) / steps if ks else None
