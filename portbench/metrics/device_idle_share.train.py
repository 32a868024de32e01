"""% of the traced training call in which no kernel, copy or set ran on any
stream: 1 - the union of their intervals over the stretch."""
from portbench import readings


def read(facts: dict):
    return readings.idle_share(facts)
