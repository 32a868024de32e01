"""`gather_rows`'s share of its byte roofline in training: the bytes the
traced steps' two gathers need (the lookup of each step's ids, the update's
permute of its value rows; `roofline.train_step_gather_bytes`) over the
card's byte rate, against the kernel's summed time. None unless the kernel
ran exactly twice a step."""
from portbench import readings, roofline


def read(facts: dict):
    steps = facts.get("traced_batches", [])
    ks = readings.kernels(facts, kernel="gather_rows")
    if not steps or len(ks) != 2 * len(steps):
        return None
    nbytes = sum(roofline.train_step_gather_bytes(
        facts["n_ids"], facts["unique"][b], facts["dim"]) for b in steps)
    return readings.bandwidth_share(facts, nbytes, ks)
