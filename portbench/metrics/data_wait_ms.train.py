"""Host ms a training step waits for its batch: the port's telemetry phase
"data" of `models.train._run_loop` (the `io.loader.DevicePrefetcher`
hand-off), over the window's untraced calls."""
from portbench import readings


def read(facts: dict):
    return readings.phase_ms(facts, "data")
