"""The ragged bag gather's share of its byte roofline in training: the
bytes the traced steps' lookups need (`bag_gather_bytes`) over the card's
byte rate, against the summed time of the `gather_bags_` kernels. None
where no such kernel ran or the facts do not count the bags."""
from portbench import readings


def bag_gather_bytes(n: int, unique: int, d: int, bags: int,
                     itemsize: int = 4) -> int:
    """n int32 ids read, each of the `unique` distinct rows read once, and
    the `bags` sums written once."""
    return 4 * n + unique * d * itemsize + bags * d * itemsize


def read(facts: dict):
    steps = facts.get("traced_batches", [])
    ks = readings.kernels(facts, kernel="gather_bags")
    if not steps or not ks or "n_bags" not in facts:
        return None
    nbytes = sum(bag_gather_bytes(facts["n_ids"], facts["unique"][b],
                                  facts["dim"], facts["n_bags"])
                 for b in steps)
    return readings.bandwidth_share(facts, nbytes, ks)
