"""Host ms a training step takes to enqueue: the port's telemetry phase
"step" around the family's train step, over the window's untraced calls.
Host time, not device time: the step returns before its kernels run."""
from portbench import readings


def read(facts: dict):
    return readings.phase_ms(facts, "step")
