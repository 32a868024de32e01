"""The update permute's share of its byte roofline in a multi-hot training
step: the bytes the traced steps' permutes need (`permute_bytes`) over the
card's byte rate, against the summed time of the `gather_rows` kernels.
On the multi-hot path the permute is the step's one `gather_rows` launch:
it reads each sorted id's value from the `(T * B, D)` bag gradient by its
bag. None unless the facts count the bags and the kernel ran exactly once
a step."""
from portbench import readings


def permute_bytes(n: int, bags: int, d: int, itemsize: int = 4) -> int:
    """n int32 source rows read, each of the `bags` gradient rows read once,
    and the n value rows written once."""
    return 4 * n + bags * d * itemsize + n * d * itemsize


def read(facts: dict):
    steps = facts.get("traced_batches", [])
    ks = readings.kernels(facts, kernel="gather_rows")
    if not steps or "n_bags" not in facts or len(ks) != len(steps):
        return None
    nbytes = len(steps) * permute_bytes(facts["n_ids"], facts["n_bags"],
                                        facts["dim"])
    return readings.bandwidth_share(facts, nbytes, ks)
