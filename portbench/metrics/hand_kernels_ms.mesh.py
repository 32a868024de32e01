"""Device ms a sharded step spends in the port's hand kernels, rank 0."""
from portbench import readings


def read(facts: dict):
    return readings.per_traced_step_ms(facts, hand=True)
