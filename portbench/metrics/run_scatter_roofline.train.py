"""The run-scatter's share of its byte roofline in training: the bytes the
traced steps' updates need (`roofline.run_scatter_bytes`: values and row
ids read once, each distinct row, and row-wise AdaGrad's accumulator, read
and written once) over the card's byte rate, against the summed time of
the `runscatter_` kernels."""
from portbench import readings, roofline


def read(facts: dict):
    steps = facts.get("traced_batches", [])
    ks = readings.kernels(facts, kernel="run_scatter")
    if not steps:
        return None
    nbytes = sum(roofline.run_scatter_bytes(
        facts["n_ids"], facts["unique"][b], facts["dim"], facts["adagrad"])
        for b in steps)
    return readings.bandwidth_share(facts, nbytes, ks)
