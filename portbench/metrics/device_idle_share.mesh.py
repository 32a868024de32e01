"""% of rank 0's traced call in which no operation ran on its card
(the union of every stream's intervals)."""
from portbench import readings


def read(facts: dict):
    return readings.idle_share(facts)
