"""The sharded step's share of the four cards' bf16 peak
(`readings.step_mfu`)."""
from portbench import readings


def read(facts: dict):
    return readings.step_mfu(facts)
