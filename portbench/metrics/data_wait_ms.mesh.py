"""Host ms a step of the sharded loop waits for its batch (telemetry
phase "data" of `models.train._run_loop`), rank 0, untraced calls."""
from portbench import readings


def read(facts: dict):
    return readings.phase_ms(facts, "data")
