"""Host ms to enqueue a sharded step (telemetry phase "step" around
`parallel.dlrm.gather_train_step`), rank 0, untraced calls: host time."""
from portbench import readings


def read(facts: dict):
    return readings.phase_ms(facts, "step")
